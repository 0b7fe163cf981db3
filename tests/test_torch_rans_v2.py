"""htscodecs_tpu_torch.ops.rans_v2 helpers against the JAX package's,
on the same numpy inputs, exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from htscodecs_tpu import native as ref_native
from htscodecs_tpu.ops import rans_v2 as ref
from htscodecs_tpu_torch.ops import rans_v2 as port
from htscodecs_tpu_torch.utils import testdata

pytestmark = pytest.mark.skipif(not ref_native.available(),
                                reason="native host kernels unavailable")


def _same3(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]


def test_constants_match():
    for nm in ("RANS_L", "CHUNK", "MAX_DENSE_A", "SEG", "SEG_CAP",
               "SEG_CAP2", "PACK_SHIFT", "PACK_MASK"):
        assert getattr(port, nm) == getattr(ref, nm), nm
    for a in range(1, 130):
        assert port._round_a(a) == ref._round_a(a)


def _o1_full(seed, B, n, a):
    rng = np.random.default_rng(seed)
    f2d = np.zeros((B, 256, 256), np.uint32)
    b2d = np.zeros((B, 256, 256), np.uint32)
    for b in range(B):
        blk = rng.integers(30, 30 + a, size=n).astype(np.uint8)
        r = ref_native.build_tables_o1(blk)
        b2d[b], f2d[b] = r[1], r[2]
    return f2d, b2d


@pytest.mark.parametrize("a", [3, 40, 120])
def test_densify_group_and_extract(a):
    f2d, b2d = _o1_full(a, 3, 900, a)
    _same3(port.densify_group(f2d.copy(), b2d.copy()),
           ref.densify_group(f2d.copy(), b2d.copy()))
    e_p = port.extract_dense(f2d[0], b2d[0])
    e_r = ref.extract_dense(f2d[0], b2d[0])
    assert (e_p is None) == (e_r is None)
    if e_p is not None:
        np.testing.assert_array_equal(e_p[0], e_r[0])
        np.testing.assert_array_equal(e_p[1], e_r[1])
    _same3(port.densify_builds((f2d[b], b2d[b]) for b in range(3)),
           ref.densify_builds((f2d[b], b2d[b]) for b in range(3)))


@pytest.mark.parametrize("a", [2, 17, 97])
def test_densify_builds_pre_extracted_and_o0(a):
    rng = np.random.default_rng(a)
    blks = [rng.integers(40, 40 + a, size=700).astype(np.uint8)
            for _ in range(4)]
    res = [ref_native.build_tables_o1_dense(b) for b in blks]
    if all(r is not None for r in res):
        _same3(port.densify_builds((r[1], r[2]) for r in res),
               ref.densify_builds((r[1], r[2]) for r in res))
    o0 = [ref_native.build_tables_o0(b) for b in blks]
    st = np.stack([r[1] for r in o0])
    fr = np.stack([r[2] for r in o0])
    _same3(port.densify_group_o0(fr.copy(), st.copy()),
           ref.densify_group_o0(fr.copy(), st.copy()))


@pytest.mark.parametrize("B,N,a", [(3, 33, 3), (5, 512, 40), (2, 100, 90)])
def test_densify_tensor(B, N, a):
    blocks = testdata.synth_wide(B, N, a, seed=N)
    alpha, _packed, _A = testdata.synth_tables(blocks, 12, 1)
    want = np.asarray(ref._densify(jnp.asarray(blocks), jnp.asarray(alpha)))
    got = port._densify(torch.from_numpy(blocks), torch.from_numpy(alpha))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shift", [10, 12, "vector"])
@pytest.mark.parametrize("order", [0, 1])
def test_b16_fill(shift, order):
    B, N = 6, 300
    blocks = testdata.synth_wide(B, N, 11, seed=5)
    blocks[:, 200:] = blocks[:, 199:200]        # rows with holes, a run
    if shift == "vector":
        sv = np.array([10, 12, 12, 10, 12, 10], np.int32)
        s_ref, s_port = jnp.asarray(sv), torch.from_numpy(sv)
    else:
        sv = shift
        s_ref = s_port = shift
    alpha, packed, A = testdata.synth_tables(blocks, sv, order)
    pk = packed if order == 1 else packed[:, None, :]
    assert ((pk & ref.PACK_MASK) == 0).any(), "no holes in the rows"
    want = np.asarray(ref._b16_fill(jnp.asarray(pk), s_ref))
    got = port._b16_fill(torch.from_numpy(pk), s_port)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.diff(want, axis=2) >= 0).all()


@pytest.mark.parametrize("N", [64, 65, 66, 67])
@pytest.mark.parametrize("order", [0, 1])
def test_enc_proc_inputs(N, order):
    """order 0: first-step pad 0..3; order 1: state-3 tail 0..3."""
    B = 3
    rng = np.random.default_rng(N)
    dense = rng.integers(0, 7, size=(B, N)).astype(np.int32)
    sym_r, ctx_r, val_r, K_r, g_r = ref._enc_proc_inputs(
        jnp.asarray(dense), N, order)
    sym_p, ctx_p, val_p, K_p, g_p = port._enc_proc_inputs(
        torch.from_numpy(dense), N, order)
    assert (K_p, int(g_p)) == (K_r, int(g_r))
    np.testing.assert_array_equal(sym_p.numpy(), np.asarray(sym_r))
    np.testing.assert_array_equal(ctx_p.numpy(), np.asarray(ctx_r))
    np.testing.assert_array_equal(val_p.numpy(), np.asarray(val_r))
    # block-major storage: the (B, 4K) view the encoder reads is free
    assert sym_p.permute(2, 0, 1).is_contiguous()


def test_enc_proc_inputs_rejects_quarterless_order1():
    with pytest.raises(ValueError):
        port._enc_proc_inputs(torch.zeros((2, 3), dtype=torch.int32), 3, 1)
