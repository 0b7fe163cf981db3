"""The round-trip steps and host table helpers
(htscodecs_tpu_torch.parallel.pipeline) and the v1 oracle engines
(htscodecs_tpu_torch.ops.rans_jax), device="cpu", against the JAX
package on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from htscodecs_tpu import native as ref_native
from htscodecs_tpu.ops import rans_jax as ref_rans_jax
from htscodecs_tpu.parallel import pipeline as ref_pipeline
from htscodecs_tpu_torch import native
from htscodecs_tpu_torch.ops import rans_jax
from htscodecs_tpu_torch.parallel import pipeline
from htscodecs_tpu_torch.utils import testdata

pytestmark = pytest.mark.skipif(not ref_native.available(),
                                reason="native host kernels unavailable")

B, N = 8, 256          # __graft_entry__.entry()'s shape
CPU = "cpu"


def _tiny_batch(B=B, N=N, seed=0):
    rng = np.random.default_rng(seed)
    sym = np.array([35, 45, 56, 70], np.uint8)
    return sym[rng.integers(0, 4, (B, N))]


def _dense(blocks):
    got = pipeline.build_o1_tables_dense(blocks, threads=False)
    assert got is not None
    return got


def test_build_o1_tables_dense_matches_jax():
    blocks = _tiny_batch()
    got = _dense(blocks)
    want = ref_pipeline.build_o1_tables_dense(blocks, threads=False)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:]
    assert pipeline.build_o1_tables_dense(blocks, threads=True)[3] == want[3]


def test_build_o1_tables_dense_refuses_mixed_shifts():
    # block 20 of this batch takes the 12-bit tables, block 19 10 bits
    mixed = testdata.synth_quality(21, 65536, seed=42)[19:]
    shifts = {native.build_tables_o1_dense(b)[3] for b in mixed}
    assert len(shifts) == 2
    assert pipeline.build_o1_tables_dense(mixed) is None
    assert ref_pipeline.build_o1_tables_dense(mixed) is None


@pytest.mark.parametrize("use_native", [True, False])
def test_build_o1_tables_matches_jax(use_native, monkeypatch):
    """The native table build and the pure-numpy path both give the JAX
    package's (native) tables and headers."""
    blocks = np.concatenate([_tiny_batch(3), _tiny_batch(2, N, seed=4) % 7])
    want = ref_pipeline.build_o1_tables(blocks)
    if not use_native:
        monkeypatch.setattr(pipeline.native, "available", lambda: False)
    got = pipeline.build_o1_tables(blocks)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]


def test_build_o1_batch_inputs_matches_jax():
    blocks = _tiny_batch()
    st, fr, sh, _h = pipeline.build_o1_tables(blocks)
    got = pipeline.build_o1_batch_inputs(blocks, st, fr, int(sh[0]))
    want = ref_pipeline.build_o1_batch_inputs(blocks, st, fr, int(sh[0]))
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[3:] == want[3:]


def test_roundtrip_o1_v2_matches_jax():
    blocks = _tiny_batch()
    alpha, packed, shift, _ = _dense(blocks)
    want = ref_pipeline.roundtrip_o1_v2(
        jnp.asarray(blocks), jnp.asarray(alpha), jnp.asarray(packed), shift, N)
    got = pipeline.roundtrip_o1_v2(blocks, alpha, packed, shift, N, device=CPU)
    assert got == (0, int(want[1])) and int(want[0]) == 0
    # the bytes are the payloads of the host coder's streams
    hdrs = _dense(blocks)[3]
    payload = sum(len(native.enc_o1(b)) - len(h) for b, h in zip(blocks, hdrs))
    assert got[1] == payload


def test_roundtrip_o1_v2_counts_mismatches():
    """Blocks that the tables do not describe decode to other bytes,
    and the step counts them."""
    blocks = _tiny_batch()
    alpha, packed, shift, _ = _dense(blocks)
    other = blocks.copy()
    other[:, 0] = blocks[:, 1]
    mism, _n = pipeline.roundtrip_o1_v2(other, alpha, packed, shift, N,
                                        device=CPU)
    assert mism > 0


def test_sharded_roundtrip_o1_v2_on_two_devices():
    blocks = _tiny_batch(B=7)
    alpha, packed, shift, _ = _dense(blocks)
    one = pipeline.roundtrip_o1_v2(blocks, alpha, packed, shift, N,
                                   device=CPU)
    two = pipeline.sharded_roundtrip_o1_v2([CPU, CPU], blocks, alpha, packed,
                                           shift, N)
    assert two == one and one[0] == 0


def test_make_mesh_and_shard_batch():
    mesh = pipeline.make_mesh([CPU, torch.device(CPU)])
    assert mesh == [torch.device(CPU)] * 2
    parts = pipeline.shard_batch(mesh, np.arange(10).reshape(5, 2))
    assert [p.shape[0] for p in parts] == [3, 2]
    assert torch.equal(torch.cat(parts), torch.arange(10).reshape(5, 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pipeline.make_mesh()


def _v1_inputs():
    blocks = _tiny_batch()
    st, fr, sh, _h = pipeline.build_o1_tables(blocks)
    shift = int(sh[0])
    assert (sh == shift).all()
    return blocks, st, fr, shift


def test_roundtrip_o1_matches_jax():
    blocks, st, fr, shift = _v1_inputs()
    st_p, fr_p, va_p, K, q = pipeline.build_o1_batch_inputs(blocks, st, fr,
                                                            shift)
    want = ref_pipeline.roundtrip_o1(
        jnp.asarray(st_p), jnp.asarray(fr_p), jnp.asarray(va_p),
        jnp.asarray(fr), jnp.asarray(st), jnp.asarray(blocks), shift, K, q, N)
    got = pipeline.roundtrip_o1(st_p, fr_p, va_p, fr, st, blocks, shift, K, q,
                                N, device=CPU)
    assert got == (0, int(want[1])) and int(want[0]) == 0


def test_build_sfb_matches_jax():
    _blocks, st, fr, shift = _v1_inputs()
    want = np.asarray(ref_pipeline._build_sfb(jnp.asarray(fr), jnp.asarray(st),
                                              shift))
    got = pipeline._build_sfb(torch.from_numpy(fr.astype(np.int64)), None,
                              shift)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_v1_order1_engine_matches_jax():
    blocks, st, fr, shift = _v1_inputs()
    got = rans_jax.enc_o1_batch(blocks, st, fr, shift, device=CPU)
    want = ref_rans_jax.enc_o1_batch(blocks, st, fr, shift)
    for a, b in zip(got, want):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    states, words, counts = got
    parsed = [native.parse_tables_o1(native.build_tables_o1(b)[0] + bytes(16))
              for b in blocks]
    sfb = np.stack([p[1] for p in parsed])
    f2d = np.stack([p[2] for p in parsed])
    b2d = np.stack([p[3] for p in parsed])
    W = int(counts.max())
    dec = rans_jax.dec_o1_batch(states, words[:, :W], N, sfb, f2d, b2d, shift,
                                device=CPU)
    np.testing.assert_array_equal(dec, blocks)
    np.testing.assert_array_equal(
        dec, ref_rans_jax.dec_o1_batch(states, words[:, :W], N, sfb, f2d, b2d,
                                       shift))


def test_v1_order0_engine_matches_jax():
    blocks = _tiny_batch(B, 258)            # N % 4 != 0: padded lanes
    tabs = [native.build_tables_o0(b) for b in blocks]
    start = np.stack([t[1] for t in tabs])
    freq = np.stack([t[2] for t in tabs])
    got = rans_jax.enc_o0_batch(blocks, start, freq, device=CPU)
    want = ref_rans_jax.enc_o0_batch(blocks, start, freq)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    states, words, counts = got
    luts = [native.parse_tables_o0(t[0] + bytes(16)) for t in tabs]
    ssym, sfreq, sbase = (np.stack([lu[k] for lu in luts]) for k in (1, 2, 3))
    W = int(counts.max())
    dec = rans_jax.dec_o0_batch(states, words[:, :W], 258, ssym, sfreq, sbase,
                                device=CPU)
    np.testing.assert_array_equal(dec, blocks)
    np.testing.assert_array_equal(
        dec, ref_rans_jax.dec_o0_batch(states, words[:, :W], 258, ssym, sfreq,
                                       sbase))


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    blocks = _tiny_batch()
    alpha, packed, shift, _ = _dense(blocks)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.roundtrip_o1_v2(blocks, alpha, packed, shift, N)
    _b, st, fr, sh = _v1_inputs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rans_jax.enc_o1_batch(blocks, st, fr, sh)
