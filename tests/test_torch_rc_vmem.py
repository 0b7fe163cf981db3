"""The port's range-coder chain over replayed triples (ops/rc_vmem.py,
plain version on device="cpu") against the JAX package's Pallas kernel
in interpret mode, the Python RangeEncoders of both packages and the
native fqz encoder, after tests/test_rc_vmem.py; and the kernel's
reciprocal division in plain form.  Exact equality throughout."""

import numpy as np
import pytest
import torch

from htscodecs_tpu import native as ref_native
from htscodecs_tpu.ops import rc_vmem as ref_rc_vmem
from htscodecs_tpu.ops.range_coder import RangeEncoder as RefRangeEncoder
from htscodecs_tpu_torch import native as port_native
from htscodecs_tpu_torch.models import fqz as port_fqz
from htscodecs_tpu_torch.ops import convert
from htscodecs_tpu_torch.ops import rc_vmem as port
from htscodecs_tpu_torch.ops.range_coder import RangeEncoder
from htscodecs_tpu_torch.utils import testdata

pytestmark = pytest.mark.skipif(
    not (ref_native.available() and port_native.available()),
    reason="native host kernels unavailable")


def _mk_jobs(B, nrec, L, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(28 + (b % 3), 42, (nrec * L,)).astype(np.uint8),
             [L] * nrec, [0] * nrec) for b in range(B)]


def _replay(jobs):
    """Triples and the native encoder's payloads of the same jobs."""
    tris, refs = [], []
    for data, lens, flags in jobs:
        gp = port_fqz.pick_parameters(4, 0, lens, list(flags), data.copy())
        packed = port_fqz._pack_gp(gp)
        args = (data, np.asarray(lens, np.uint32),
                np.asarray(flags, np.uint32), gp, packed)
        refs.append(port_native.fqz_enc_scan(*args))
        tris.append(port_native.fqz_enc_replay(*args))
        assert refs[-1] is not None and tris[-1] is not None
    return tris, refs


def _python_rc(tri):
    rc = RangeEncoder()
    for a, f, t in zip(*(x.tolist() for x in tri)):
        rc.encode(a, f, t)
    return rc.finish()


def test_equals_the_pallas_kernel_and_the_native_encoder():
    """tests/test_rc_vmem.py's kernel case: per_r=8, interpret mode."""
    tris, refs = _replay(_mk_jobs(3, 3, 20, 7))
    got = port.enc_triples_batch(tris, device="cpu")
    assert got == ref_rc_vmem.enc_triples_batch(tris, per_r=8, interpret=True)
    assert got == refs


def test_replayed_triples_equal_the_python_coder_and_fqz_enc_scan():
    tris, refs = _replay(_mk_jobs(4, 24, 40, 3))
    got = port.enc_triples_batch(tris, device="cpu")
    assert got == refs
    assert got == [_python_rc(t) for t in tris]


@pytest.mark.parametrize("case", ["deferred_runs", "random_ragged", "empty_row"])
def test_equals_the_python_coder(case):
    if case == "deferred_runs":
        tris = [testdata.ff_run_triples(r) for r in (120, 1, 40)]
    elif case == "random_ragged":
        tris = testdata.random_triples(9, 150, seed=4)
    else:
        e = np.zeros(0, np.uint16)
        tris = [(e, e, e)] + testdata.random_triples(2, 20, seed=6)
    got = port.enc_triples_batch(tris, device="cpu")
    assert got == [_python_rc(t) for t in tris]
    if case == "empty_row":
        assert got[0] == bytes(5) and port.enc_triples_batch(
            [], device="cpu") == []


def test_wrapper_and_conversion():
    tris = testdata.random_triples(5, 40, seed=8)
    acc, f, tot, cn = convert.triples_from_reference(tris, "cpu")
    assert acc.dtype == torch.int16 and acc.shape == (5, 40)
    assert cn.tolist() == [40, 37, 34, 31, 28]
    # u16 values above 32767 travel as negative int16 bit patterns
    assert (tot < 0).any() and int(tot[0, 0]) & 0xFFFF == int(tris[0][2][0])
    by, nb = port.rc_enc(acc, f, tot, cn)
    assert by.shape == (5, 2 * 40 + 8)
    assert convert.payloads_to_reference(by, nb) == \
        [_python_rc(t) for t in tris]
    with pytest.raises(ValueError):
        port.rc_enc(acc.to(torch.int32), f, tot, cn)


# ---------------------------------------------------------------------------
# the kernel's division and the inputs of its comparison grid

def test_reciprocal_division_is_exact():
    """rc_enc.cu divides the range by a 16-bit total through a staged
    reciprocal and one correction: exact for every total, a total of 0
    taken as 1, at the edges of each quotient and at random ranges."""
    d = np.arange(65536, dtype=np.int64)[:, None]
    edges = np.concatenate(
        [np.maximum(d - 1, 0), d, d + 1,
         np.broadcast_to(np.array([0, 1, 2**24 - 1, 2**24, 2**32 - 1]),
                         (65536, 5)),
         np.random.default_rng(5).integers(0, 2**32, (65536, 8))], axis=1)
    got = port._udiv_recip_plain(edges, d)
    want = edges // np.maximum(d, 1)
    np.testing.assert_array_equal(got.astype(np.int64), want)


def _ref_rc(tri):
    """The JAX package's Python coder.  Like its Pallas kernel
    (htscodecs_tpu/ops/rc_vmem.py: jnp.maximum(tot, 1), jnp.maximum(f,
    1)) the port takes a total or a frequency of 0 as 1; the Python
    coder would divide by zero, so it is handed the 1."""
    rc = RefRangeEncoder()
    for a, f, t in zip(*(x.tolist() for x in tri)):
        rc.encode(a, max(f, 1), max(t, 1))
    return rc.finish()


def _tri(rows):
    return tuple(np.array(c, np.uint16) for c in zip(*rows))


def _grid_case(case):
    rng = np.random.default_rng(11)
    if case == "long_deferred_run":
        return [testdata.ff_run_triples(5000)]
    if case == "ragged_around_32_64":
        return [t for n in (31, 32, 33, 63, 64, 65)
                for t in testdata.random_triples(1, n, seed=n)]
    if case == "tot_0":
        # acc 0, f 0 or 1, tot 0: coded as (0, 1, 1), between valid events
        valid = testdata.random_triples(1, 40, seed=2)[0]
        rows = [tuple(int(x[k]) for x in valid) for k in range(40)]
        for k in (0, 7, 8, 39):
            rows[k] = (0, k % 2, 0)
        return [_tri(rows)]
    # tot 65535: the range loses 16 bits, the most an event can take
    k = 300
    f = rng.integers(1, 4, k)
    acc = rng.integers(0, 65535 - 3, k)
    return [_tri(zip(acc, f, [65535] * k))]


@pytest.mark.parametrize("case", ["long_deferred_run", "ragged_around_32_64",
                                  "tot_0", "tot_65535"])
def test_grid_inputs_equal_the_jax_coder(case):
    tris = _grid_case(case)
    acc, f, tot, cn = convert.triples_from_reference(tris, "cpu")
    got = convert.payloads_to_reference(*port._rc_enc_plain(acc, f, tot, cn))
    assert got == [_ref_rc(t) for t in tris]
    if case == "long_deferred_run":
        # the run of 0xFF bytes is longer than any ring the grid uses
        assert b"\xff" * 4096 in got[0]
