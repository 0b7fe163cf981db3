"""htscodecs_tpu_torch.ops.tables_v2 (device="cpu") against the JAX
package's ops/tables_v2 on the same numpy inputs, and the batch layer's
device-table route against the host coder.

Integer outputs are compared exactly.  The shift decision is taken in
float32 by both packages, with the sums in a different order, so the
two may flag different blocks, but only inside the SHIFT_BAND around
the threshold (outside it a float32 decision equals the f64 one):
blocks that either side flags are left out of the comparison with the
JAX package and are held against the native builder after the exact
f64 replay instead.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from htscodecs_tpu.ops import tables_v2 as ref
from htscodecs_tpu_torch import native
from htscodecs_tpu_torch.models import batch, rans4x16
from htscodecs_tpu_torch.ops import tables_v2 as port

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native host library unavailable")


def _cases():
    # the shapes of tests/test_tables_v2.py (B=4, N=2048 but two)
    rng = np.random.default_rng(123)
    N, B = 2048, 4
    out = []
    syms = np.array([35, 45, 56, 70], np.uint8)
    vals = rng.choice(4, size=(B, N), p=[.05, .1, .15, .7])
    out.append(("a4", syms[vals]))
    out.append(("a8uni", (rng.integers(0, 8, (B, N)) + 33).astype(np.uint8)))
    p = np.exp(-0.2 * np.arange(40)); p /= p.sum()
    out.append(("a40", (rng.choice(40, size=(B, N), p=p) + 33).astype(np.uint8)))
    out.append(("single", np.full((B, N), 77, np.uint8)))
    out.append(("two", np.where(rng.random((B, N)) < 0.999, 40, 41).astype(np.uint8)))
    out.append(("zero", (rng.integers(0, 5, (B, N)) * 7).astype(np.uint8)))
    out.append(("a90", (rng.integers(0, 90, (B, N)) + 33).astype(np.uint8)))
    out.append(("odd", rng.integers(33, 43, (B, 1237)).astype(np.uint8)))
    # flat small rows stress the normaliser's retry/redistribute paths
    out.append(("flat", (rng.integers(0, 64, (B, 300)) + 33).astype(np.uint8)))
    return out


def _band_blocks():
    """(6, 16384) run-structured quality data, the input of
    tests/test_tables_v2.py::test_shift_band_resolution: it sits right
    at the e10/e12 = 1.01 boundary."""
    rng = np.random.default_rng(11)
    N, B = 16384, 6
    syms = np.array([35, 45, 56, 70], np.uint8)
    out = np.empty((B, N), np.uint8)
    for b in range(B):
        vals = rng.choice(4, size=N // 8, p=[.05, .1, .15, .7])
        lens = rng.geometric(0.25, size=N // 8).clip(1, 60)
        seq = np.repeat(vals, lens)[:N]
        if len(seq) < N:
            seq = np.pad(seq, (0, N - len(seq)), constant_values=3)
        out[b] = syms[seq]
    return out


def _fuzz_blocks():
    rng = np.random.default_rng(999)
    out = []
    for trial in range(8):
        N, B = 777, 4
        a = int(rng.integers(1, 90))
        logits = rng.normal(0, rng.uniform(0.2, 4.0), a)
        p = np.exp(logits); p /= p.sum()
        lo = int(rng.integers(0, 120))
        out.append((f"fuzz{trial}",
                    (rng.choice(a, size=(B, N), p=p) + lo).astype(np.uint8)))
    return out


def _check_o1(blocks, name):
    """Port vs JAX on blocks neither flags; every block the port's
    exact replay keeps is held against the native builder."""
    r = ref.build_o1_device_async(blocks)
    p = port.build_o1_device_async(blocks, device="cpu")
    assert r is not None and p is not None
    assert p[5] == r[5], name
    alpha_r, packed_r, fhdr_r, meta_r, H_r = (np.asarray(x) for x in r[:5])
    alpha_p, packed_p, fhdr_p, meta_p, H_p = (x.numpy() for x in p[:5])
    assert fhdr_p.dtype == np.int16 and packed_p.dtype == np.int32
    assert meta_p.dtype == np.int32 and H_p.dtype == np.int32
    calm = (meta_r[:, 2] == 0) & (meta_p[:, 2] == 0)
    np.testing.assert_array_equal(alpha_p[calm], alpha_r[calm], name)
    np.testing.assert_array_equal(packed_p[calm], packed_r[calm], name)
    np.testing.assert_array_equal(fhdr_p[calm].astype(np.int64),
                                  fhdr_r[calm].astype(np.int64), name)
    np.testing.assert_array_equal(meta_p[calm, :2], meta_r[calm, :2], name)
    np.testing.assert_array_equal(H_p, H_r, name)   # exact counts everywhere

    flag = port.resolve_band_flags(meta_p, p[4])
    hdrs = native.serialize_o1_dense_batch(
        alpha_p, meta_p[:, 0], fhdr_p.view(np.uint16), meta_p[:, 1])
    assert hdrs is not None
    for b in range(blocks.shape[0]):
        if flag[b]:
            continue            # the batch layer rebuilds it on the host
        h_ref, al_ref, pk_ref, sh_ref = native.build_tables_o1_dense(blocks[b])
        a = len(al_ref)
        assert meta_p[b, 0] == a and meta_p[b, 1] == sh_ref, (name, b)
        np.testing.assert_array_equal(alpha_p[b, :a], al_ref)
        np.testing.assert_array_equal(packed_p[b, :a, :a], pk_ref)
        assert hdrs[b] == h_ref, (name, b)


@pytest.mark.parametrize("name,blocks", _cases() + _fuzz_blocks())
def test_o1_build_matches_jax_and_native(name, blocks):
    _check_o1(blocks, name)


def test_shift_band_resolution():
    """Run-structured quality data: banded blocks resolve through the
    exact f64 replay so that every block kept has the native builder's
    shift and header."""
    blocks = _band_blocks()
    _check_o1(blocks, "band")
    r = port.build_o1_device_async(blocks, device="cpu")
    meta = r[3].numpy()
    # the exact replay agrees with the JAX package's on every block
    Hn = r[4].numpy()
    for b in range(len(blocks)):
        assert port._pick_shift_exact(Hn[b], int(meta[b, 0])) == \
            ref._pick_shift_exact(Hn[b], int(meta[b, 0]))


@pytest.mark.parametrize("name,blocks", _cases())
def test_o0_build_matches_jax_and_native(name, blocks):
    r = ref.build_o0_device(blocks)
    p = port.build_o0_device(blocks, device="cpu")
    alpha_r, packed_r, asz_r, fhdr_r, A_r = r
    alpha_p, packed_p, asz_p, fhdr_p, A_p = p
    assert A_p == A_r
    np.testing.assert_array_equal(alpha_p.numpy(), np.asarray(alpha_r))
    np.testing.assert_array_equal(packed_p.numpy(), np.asarray(packed_r))
    np.testing.assert_array_equal(asz_p, asz_r)
    assert fhdr_p.dtype == np.uint16
    np.testing.assert_array_equal(fhdr_p, fhdr_r)
    hdrs = native.serialize_o0_batch(fhdr_p)
    for b in range(blocks.shape[0]):
        assert hdrs[b] == native.build_tables_o0(blocks[b])[0], (name, b)


def _normalise_freq_c(F, size, tot):
    """Scalar replay of the reference normalise_freq
    (rANS_static4x16pr.c:116-161) in Python ints.  Returns (F, path):
    path 1 = first pass, 2 = retry pass, 3 = the hard path."""
    F = [int(x) for x in F]
    if not size:
        return F, 0
    loop = 0
    while True:
        tr = (tot << 31) // size + (1 << 30) // size
        size = m = M = 0
        for j in range(len(F)):
            if not F[j]:
                continue
            if m < F[j]:
                m, M = F[j], j
            F[j] = (F[j] * tr) >> 31
            if F[j] == 0:
                F[j] = 1
            size += F[j]
        adjust = tot - size
        if adjust >= 0:
            F[M] += adjust
            return F, loop + 1
        if F[M] > -adjust and (loop == 1 or F[M] // 2 >= -adjust):
            F[M] += adjust
            return F, loop + 1
        if loop < 1:
            loop += 1
            continue
        adjust += F[M] - 1
        F[M] = 1
        for j in range(len(F)):
            if not adjust:
                break
            if F[j] < 2:
                continue
            d = F[j] > -adjust
            mm = adjust if d else 1 - F[j]
            F[j] += mm
            adjust -= mm
        return F, 3


def test_normaliser_matches_reference_and_jax_on_every_path():
    """Flat small rows overflow the target through the max(P, 1) floor,
    so the retry pass (one peak over many ones) and the hard path are
    taken; large rows exercise the int64 product (the JAX package needs
    two int32 limbs for it)."""
    rng = np.random.default_rng(31)
    rows, sizes, tots = [], [], []
    for _ in range(400):
        A = 96
        n = int(rng.integers(1, A + 1))
        F = np.zeros(A, np.int64)
        idx = rng.choice(A, size=n, replace=False)
        kind = rng.random()
        if kind < 0.2:                            # one peak over ones
            F[idx] = 1
            F[idx[0]] = rng.integers(4, 20)
            tot = int(rng.choice([32, 64]))
        elif kind < 0.6:                          # flat, small
            F[idx] = rng.integers(1, 4, n)
            tot = int(rng.choice([16, 32, 64, 128]))
        else:
            F[idx] = rng.integers(1, 1 << int(rng.integers(2, 16)), n)
            tot = int(rng.choice([256, 1024, 4096]))
        rows.append(F)
        sizes.append(int(F.sum()))
        tots.append(tot)
    rows.append(np.zeros(96, np.int64))            # size 0 passes through
    sizes.append(0)
    tots.append(1024)
    F = np.stack(rows)
    size = np.array(sizes)
    tot = np.array(tots)
    got = port._norm_freq_rows(torch.from_numpy(F), torch.from_numpy(size),
                               torch.from_numpy(tot)).numpy()
    jax_out = np.asarray(ref._norm_freq_rows(
        jnp.asarray(F.astype(np.int32)), jnp.asarray(size.astype(np.int32)),
        jnp.asarray(tot.astype(np.int32))))
    paths = set()
    for r in range(len(F)):
        want, path = _normalise_freq_c(F[r], sizes[r], tots[r])
        paths.add(path)
        np.testing.assert_array_equal(got[r], want, err_msg=str(r))
    np.testing.assert_array_equal(got, jax_out)
    assert {1, 2, 3} <= paths


@pytest.mark.parametrize("order", [0, 1])
def test_compress_blocks_device_table_route_is_byte_exact(order, monkeypatch):
    """compress_blocks through the device-table route (the threshold
    patched down to 8 blocks) gives the host coder's streams and they
    round-trip."""
    monkeypatch.setattr(batch, "TABLES_DEVICE_MIN", 8)
    rng = np.random.default_rng(5)
    N, B = 640, 24
    blocks = (rng.integers(0, 10, (B, N)) + 33).astype(np.uint8)
    before = dict(batch.TABLE_ROUTES)
    got = batch.compress_blocks(list(blocks), order, engine="device",
                                device="cpu")
    assert batch.TABLE_ROUTES["device"] == before["device"] + 1
    assert batch.TABLE_ROUTES["host"] == before["host"]
    for b in range(B):
        assert got[b] == rans4x16.compress(blocks[b], order), b
    back = batch.uncompress_blocks(got, device="cpu")
    assert back == [blocks[b].tobytes() for b in range(B)]


def test_small_groups_take_the_host_table_route():
    rng = np.random.default_rng(6)
    blocks = (rng.integers(0, 10, (20, 300)) + 33).astype(np.uint8)
    before = dict(batch.TABLE_ROUTES)
    got = batch.compress_blocks(list(blocks), 1, engine="device",
                                device="cpu")
    assert batch.TABLE_ROUTES["host"] == before["host"] + 1
    assert batch.TABLE_ROUTES["device"] == before["device"]
    assert got == [rans4x16.compress(b, 1) for b in blocks]


def test_tables_built_event_is_on_the_batch_device(monkeypatch):
    """The order-1 device-table route records its "tables built" event
    on the current stream of the batch's device, not of whichever
    device is current, so the header copies wait for that build."""
    seen = []

    class FakeEvent:
        def record(self, stream=None):
            seen.append(stream)

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: ("stream of", device))
    dev = torch.device("cuda", 1)
    assert isinstance(batch._mark(dev), FakeEvent)
    assert seen == [("stream of", dev)]
    assert batch._mark(torch.device("cpu")) is None


def test_tile_rows_bound_the_per_pass_tensors():
    """A histogram pass holds at most ``_TILE_BYTES`` of int32 per
    (tile, N) tensor, and never more than the caller's tile."""
    assert port._tile_rows(port.TILE, 65536) == port.TILE
    assert port._tile_rows(300, 65536) == 300
    big = port._tile_rows(port.TILE, 1 << 20)
    assert big * (1 << 20) * 4 <= port._TILE_BYTES and big >= 1
    assert port._tile_rows(port.TILE, (1 << 23) - 1) >= 1


def test_builders_refuse_what_the_host_route_takes():
    wide = np.tile(np.arange(256, dtype=np.uint8), (2, 2))   # 256 symbols
    assert port.build_o1_device_async(wide, device="cpu") is None
    assert port.build_o0_device(wide, device="cpu") is None
    assert port.build_o1_device_async(np.zeros((2, 3), np.uint8),
                                      device="cpu") is None


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.build_o1_device(np.zeros((2, 64), np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.build_o0_device(np.zeros((2, 64), np.uint8))
