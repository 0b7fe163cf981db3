"""The port's batched arith_dynamic engine (ops/arith_vmem.py, plain
versions on device="cpu") against the JAX package's device functions
(ops/arith_jax.py; ops/arith_vmem.py in interpret mode) on the same
numpy inputs, and against the host coders where the JAX functions
return None.  Integer codecs: every comparison is exact."""

import numpy as np
import pytest
import torch

from htscodecs_tpu import native as ref_native
from htscodecs_tpu.ops import arith_jax as ref_jax
from htscodecs_tpu.ops import arith_vmem as ref_vmem
from htscodecs_tpu_torch import native as port_native
from htscodecs_tpu_torch.ops import arith_vmem as port
from htscodecs_tpu_torch.ops import convert
from htscodecs_tpu_torch.ops.range_coder import (MAX_FREQ, STEP, RangeEncoder,
                                                 SimpleModel)
from htscodecs_tpu_torch.utils import testdata

pytestmark = pytest.mark.skipif(
    not (ref_native.available() and port_native.available()),
    reason="native host kernels unavailable")


def _mkdata(rng, n, a, runs):
    """tests/test_arith_jax.py's generator."""
    if runs:
        v = rng.choice(a, size=n // 2 + 1)
        ln = rng.geometric(0.3, size=n // 2 + 1).clip(1, 20)
        d = np.repeat(v, ln)[:n]
        if len(d) < n:
            d = np.pad(d, (0, n - len(d)))
    else:
        d = rng.integers(0, a, n)
    return (d + 33).astype(np.uint8)


def _normalising(B, N):
    """One symbol repeated past 4096 times: the model's total reaches
    MAX_FREQ and every entry is halved, at order 1 too (one context
    sees nearly all of the block)."""
    blocks = np.full((B, N), 7, np.uint8)
    blocks[:, ::97] = 3
    return blocks, np.array([N] + [N - 7] * (B - 1), np.int32), \
        np.full(B, 8, np.int32)


def _host_payload(block, order):
    """The host coder's payload (after the max-symbol byte)."""
    return port_native.arith_enc(block, order == 1, False)[1:]


# ---------------------------------------------------------------------------
# against arith_jax.enc_batch / dec_batch

@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("n,a,runs", [(64, 3, False), (257, 9, False),
                                      (1000, 40, True)])
def test_enc_dec_equal_the_xla_engine(order, n, a, runs):
    rng = np.random.default_rng(23 + n)
    B = 3
    blocks = np.stack([_mkdata(rng, n, a, runs) for _ in range(B)])
    ms = blocks.max(axis=1).astype(np.int32) + 1
    lens = np.full(B, n, np.int32)
    want = ref_jax.enc_batch(blocks, lens, ms, order)
    got = port.enc_batch(blocks, lens, ms, order, device="cpu")
    assert got == want
    dec = port.dec_batch(got, [n] * B, list(ms), order, device="cpu")
    np.testing.assert_array_equal(dec, blocks)
    np.testing.assert_array_equal(
        dec, ref_jax.dec_batch(got, [n] * B, list(ms), order)[:, :n])


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("B,N,A", [(128, 100, 6), (130, 64, 40)])
def test_ragged_lens_equal_the_xla_engine(B, N, A, order):
    """tests/test_arith_vmem.py's shapes and ragged lengths."""
    rng = np.random.default_rng(3)
    blocks = rng.integers(0, A, (B, N)).astype(np.uint8)
    blocks = (blocks * blocks // max(A // 3, 1) % A).astype(np.uint8)
    lens = np.full(B, N, np.int32)
    lens[1] = N - 7
    ms = blocks.max(axis=1).astype(np.int32) + 1
    want = ref_jax.enc_batch(blocks, lens, ms, order)
    got = port.enc_batch(blocks, lens, ms, order, device="cpu")
    assert got == want
    dec = port.dec_batch(got, lens.tolist(), ms.tolist(), order, device="cpu")
    for b in range(B):
        np.testing.assert_array_equal(dec[b, :lens[b]], blocks[b, :lens[b]])
    assert not dec[1, lens[1]:].any()       # past a block's length: zeros


@pytest.mark.parametrize("order", [0, 1])
def test_normalising_input(order):
    blocks, lens, ms = _normalising(2, 4200)
    got = port.enc_batch(blocks, lens, ms, order, device="cpu")
    assert got == ref_jax.enc_batch(blocks, lens, ms, order)
    assert got == [_host_payload(blocks[b, :lens[b]], order) for b in range(2)]
    dec = port.dec_batch(got, lens.tolist(), ms.tolist(), order, device="cpu")
    for b in range(2):
        np.testing.assert_array_equal(dec[b, :lens[b]], blocks[b, :lens[b]])


@pytest.mark.parametrize("order", [0, 1])
def test_truncated_streams_decode_as_the_jax_device_functions(order):
    """A stream cut short is invalid input: the host coder stops reading
    at its end, the JAX device functions read zeros past it.  The port
    follows the device functions."""
    blocks, lens, ms = testdata.arith_blocks(4, 300, 40, seed=7)
    full = port.enc_batch(blocks, lens, ms, order, device="cpu")
    cut = [s[:-6] for s in full[:3]] + [full[3][:4]]    # the last: under 6
    got = port.dec_batch(cut, lens.tolist(), ms.tolist(), order, device="cpu")
    want = ref_jax.dec_batch(cut, lens.tolist(), ms.tolist(), order)
    for b in range(4):
        np.testing.assert_array_equal(got[b, :lens[b]], want[b, :lens[b]])
    assert not got[3].any()                 # decodes nothing: zeros
    host = port_native.arith_dec(bytes([ms[0]]) + cut[0], int(lens[0]),
                                 order == 1, False)
    assert not np.array_equal(host, got[0]), \
        "the host coder and the device functions agree here: pick another cut"


# ---------------------------------------------------------------------------
# against the Pallas kernels in interpret mode, at their smallest shape

@pytest.fixture
def short_unroll(monkeypatch):
    """The Pallas kernels unroll PER_A = 32 byte steps per grid step; in
    interpret mode on the CPU that compiles for many minutes.  Four
    steps per grid step run the same arithmetic per byte.  N = 40 is no
    multiple of 32, so no compiled kernel of the JAX package's own tests
    has these shapes."""
    monkeypatch.setattr(ref_vmem, "PER_A", 4)


def test_enc_equals_the_pallas_kernel(short_unroll):
    blocks, lens, ms = testdata.arith_blocks(5, 40, 6, seed=3)
    want = ref_vmem.enc_batch(blocks, lens, ms, 0, interpret=True)
    assert want is not None
    assert port.enc_batch(blocks, lens, ms, 0, device="cpu") == want


def test_dec_equals_the_pallas_kernel(short_unroll):
    blocks, lens, ms = testdata.arith_blocks(5, 40, 6, seed=5)
    enc = port.enc_batch(blocks, lens, ms, 0, device="cpu")
    want = ref_vmem.dec_batch(enc, lens.tolist(), ms.tolist(), 0,
                              interpret=True)
    got = port.dec_batch(enc, lens.tolist(), ms.tolist(), 0, device="cpu")
    for b in range(5):
        np.testing.assert_array_equal(got[b, :lens[b]], want[b, :lens[b]])
        np.testing.assert_array_equal(got[b, :lens[b]], blocks[b, :lens[b]])


# ---------------------------------------------------------------------------
# where the JAX device functions return None: against the host coders

@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("width", [97, 256])
def test_wide_models_equal_the_host_coder(width, order):
    blocks, lens, ms = testdata.arith_blocks(3, 400, width, seed=width)
    assert int(ms.max()) == width
    assert ref_jax.enc_batch(blocks, lens, ms, order) is None
    got = port.enc_batch(blocks, lens, ms, order, device="cpu")
    assert got == [_host_payload(blocks[b, :lens[b]], order) for b in range(3)]
    dec = port.dec_batch(got, lens.tolist(), ms.tolist(), order, device="cpu")
    for b in range(3):
        np.testing.assert_array_equal(dec[b, :lens[b]], blocks[b, :lens[b]])


def test_max_syms_outside_the_model_are_refused():
    blocks = np.zeros((2, 16), np.uint8)
    lens = np.full(2, 16, np.int32)
    for ms in ([0, 1], [1, 257]):
        with pytest.raises(ValueError, match="max_syms"):
            port.enc_batch(blocks, lens, np.array(ms, np.int32), 0,
                           device="cpu")
        with pytest.raises(ValueError, match="max_syms"):
            port.dec_batch([bytes(8)] * 2, [16, 16], ms, 0, device="cpu")


def test_empty_batches():
    assert port.enc_batch(np.zeros((0, 8), np.uint8), [], [], 0,
                          device="cpu") == []
    assert port.dec_batch([], [], [], 1, device="cpu").shape == (0, 0)


# ---------------------------------------------------------------------------
# mutations that these inputs must tell apart

class _SwapFirstModel(SimpleModel):
    """The mutation: bubble swap BEFORE the halving normalisation."""

    def encode(self, rc, sym):
        p = self.syms.index(sym)
        rc.encode(sum(self.freqs[:p]), self.freqs[p], self.total)
        self.freqs[p] += STEP
        self.total += STEP
        if p and self.freqs[p] > self.freqs[p - 1]:
            self.syms[p], self.syms[p - 1] = self.syms[p - 1], self.syms[p]
            self.freqs[p], self.freqs[p - 1] = \
                self.freqs[p - 1], self.freqs[p]
        if self.total > MAX_FREQ:
            self._normalize()


class _CarryRunEncoder(RangeEncoder):
    """The mutation: the deferred bytes take ``carry``, not
    ``carry - 1``."""

    def _shift_low(self):
        if self.low < 0xFF000000 or self.carry:
            self.out.append((self.cache + self.carry) & 0xFF)
            self.out.extend([self.carry & 0xFF] * self.ffnum)
            self.ffnum = 0
            self.cache = self.low >> 24
            self.carry = 0
        else:
            self.ffnum += 1
        self.low = (self.low << 8) & 0xFFFFFFFF


def _oracle(block, ms, model_cls, coder_cls):
    model, rc = model_cls(256, ms), coder_cls()
    for s in block.tolist():
        model.encode(rc, s)
    return rc.finish()


def _swap_sensitive_block():
    """A two-symbol block on which the order of halving and swapping
    shows.  It shows only where the coded entry leads its neighbour by
    exactly 1 and is even when the total passes MAX_FREQ, and the
    frequencies stay congruent to 1 modulo 16, 8, 4, 2 until the fourth
    halving: so the block is long.  Always coding the symbol in second
    place brings the two frequencies level; six of each then hit the
    seventh halving with the lead at 1."""
    model, head = SimpleModel(256, 2), []
    for _ in range(16370):
        head.append(model.syms[1])
        model.encode(RangeEncoder(), head[-1])
    return np.array(head + [0] * 6 + [1] * 6 + [0, 1] * 100, np.uint8)


def test_swap_before_normalise_would_be_caught():
    blk = _swap_sensitive_block()
    right = _oracle(blk, 2, SimpleModel, RangeEncoder)
    assert right != _oracle(blk, 2, _SwapFirstModel, RangeEncoder), \
        "this block does not tell the two orders apart"
    got = port.enc_batch(blk[None, :], [len(blk)], [2], 0, device="cpu")[0]
    assert got == right == _host_payload(blk, 0)


def test_run_byte_of_carry_would_be_caught():
    """Wide random data defers bytes now and then (the low word's top
    byte is 0xFF about once in 256 shifts)."""
    blocks, lens, ms = testdata.arith_blocks(1, 3000, 256, seed=2)
    blk = blocks[0, :lens[0]]
    right = _oracle(blk, 256, SimpleModel, RangeEncoder)
    assert right != _oracle(blk, 256, SimpleModel, _CarryRunEncoder), \
        "this block defers no byte: pick another seed"
    assert port.enc_batch(blocks, lens, ms, 0, device="cpu")[0] == right


# ---------------------------------------------------------------------------
# the tensor-level wrappers

def test_wrappers_take_the_plain_versions_on_cpu_tensors():
    blocks, lens, ms = testdata.arith_blocks(5, 33, 6, seed=1)
    bt, lt, mt = (torch.from_numpy(x) for x in (blocks, lens, ms))
    M = int(ms.max())
    by, cn = port.arith_enc(bt, lt, mt, M, 1)
    assert by.shape == (5, 2 * 33 + 8) and by.dtype == torch.uint8
    assert convert.payloads_to_reference(by, cn) == \
        ref_jax.enc_batch(blocks, lens, ms, 1)
    out = port.arith_dec(by[:, :int(cn.max())].contiguous(), cn, lt, mt, M,
                         33, 1)
    for b in range(5):
        assert out[b, :lens[b]].tolist() == blocks[b, :lens[b]].tolist()
    with pytest.raises(ValueError):
        port.arith_enc(bt, lt, mt, 257, 0)
    with pytest.raises(ValueError):
        port.arith_enc(bt, lt.to(torch.int64), mt, M, 0)


# ---------------------------------------------------------------------------
# the order-1 model pool of arith_dec

def _smem_bytes(M, rows):
    """A block's shared memory in the kernel: the map and the rows."""
    return 4 * port._model_words(M, 1, rows)


@pytest.mark.parametrize("smem_per_sm,sms", [(233472, 132), (167936, 108),
                                             (65536, 4)])
def test_pool_rule_bounds(smem_per_sm, sms):
    prev = {}
    for M in (1, 2, 40, 71, 74, 255, 256):
        for tpb in (1, 4, 8, 32):
            for B in (1, 7, 130, 1024, 4096, 65536):
                rows = port.pool_rows(M, B, tpb, smem_per_sm, sms)
                assert 1 <= rows <= M
                ctas = -(-B // tpb)
                per_sm = max(1, -(-ctas // sms))
                if rows > 1:
                    # every CTA the launch aims to hold per SM fits
                    assert per_sm * (tpb * _smem_bytes(M, rows) + 1024) \
                        <= smem_per_sm
                # more blocks never get more rows
                assert rows <= prev.get((M, tpb), M)
                prev[(M, tpb)] = rows
    # the H100's numbers for synth4 in the module docstring
    if (smem_per_sm, sms) == (233472, 132):
        assert port.pool_rows(71, 4096, 4, smem_per_sm, sms) == 22


def test_pool_overflow_input_equals_the_xla_engine():
    """Blocks over 40 symbols use more contexts than a small pool: the
    decode the kernel's global-bank route must give (chip_smoke.py runs
    it with pools of 1 and 2 rows)."""
    blocks, lens, ms = testdata.arith_blocks(3, 300, 40, seed=40)
    ctx = [len({0} | set(blocks[b, :lens[b] - 1].tolist())) for b in range(3)]
    assert min(ctx) > 2
    enc = ref_jax.enc_batch(blocks, lens, ms, 1)
    got = port.dec_batch(enc, lens.tolist(), ms.tolist(), 1, device="cpu")
    want = ref_jax.dec_batch(enc, lens.tolist(), ms.tolist(), 1)
    for b in range(3):
        np.testing.assert_array_equal(got[b, :lens[b]], want[b, :lens[b]])
        np.testing.assert_array_equal(got[b, :lens[b]], blocks[b, :lens[b]])
    with pytest.raises(ValueError, match="pool"):
        port.arith_dec(*(torch.from_numpy(x) for x in (
            np.zeros((3, 8), np.uint8), np.full(3, 8, np.int32),
            lens, ms)), int(ms.max()), 300, 1, pool=int(ms.max()) + 1)


def test_decoder_division_free_step_is_exact():
    """arith_dec.cu's step without divides, in numpy: r = range // total
    through the reciprocal table and one correction, and the walk's
    test x <= min(code // r, 65535) as x <= 65535 and x * r <= code for
    every cumulative frequency x up to the total (x * r <= range: no
    32-bit overflow)."""
    tab = port._recip_table(torch.device("cpu")).numpy().view(np.uint32)
    t = np.arange(65536, dtype=np.uint64)
    np.testing.assert_array_equal(
        tab.astype(np.uint64), np.uint64(0xFFFFFFFF) // np.maximum(t, 1))
    rng = np.random.default_rng(17)
    n = 200000
    total = rng.integers(1, 65536, n).astype(np.uint64)
    rnge = rng.integers(1 << 24, 1 << 32, n).astype(np.uint64)
    rnge = np.maximum(rnge, total)
    m = tab[total.astype(np.int64)].astype(np.uint64)
    q = (rnge * m) >> np.uint64(32)
    r = q + (rnge - q * total >= total)
    np.testing.assert_array_equal(r, rnge // total)
    code = (rng.random(n) * rnge).astype(np.uint64)
    x = (rng.random(n) * (total + 1)).astype(np.uint64)
    assert (x * r <= rnge).all() and (x * r < 2**32).all()
    want = x <= np.minimum(code // r, 65535)
    got = (x <= 65535) & (x * r <= code)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# arith_enc's launch: blocks per warp, the pool beside the stage buffers

@pytest.mark.parametrize("smem_per_sm,sms", [(233472, 132), (167936, 108),
                                             (65536, 4)])
def test_enc_pool_rule_bounds(smem_per_sm, sms):
    """arith_enc reserves its stage buffers (records, queue entries and
    the output ring of each block) before the order-1 rows: at least 1
    row and at most M, one CTA within the 227 KB a CTA may hold at every
    width, and the CTAs the launch aims to hold per SM within the SM."""
    prev = {}
    for M in (1, 2, 40, 71, 74, 255, 256):
        for G in (1, 4, 8, 32):
            for chunk, ring in ((port.ENC_CHUNK, port.ENC_RING), (1, 16)):
                for B in (1, 7, 130, 1024, 4096, 65536):
                    rows = port.enc_pool_rows(M, B, G, chunk, ring,
                                              smem_per_sm, sms)
                    assert 1 <= rows <= M
                    smem = port._enc_smem(M, 1, rows, G, chunk, ring)
                    assert smem <= 232448
                    per_sm = max(1, -(-(-(-B // G)) // sms))
                    if rows > 1:
                        assert per_sm * (smem + 1024) <= smem_per_sm
                    assert rows <= prev.get((M, G, chunk), M)
                    prev[(M, G, chunk)] = rows
    if (smem_per_sm, sms) == (233472, 132):
        # synth4 (4096 blocks, width 71, 5 contexts) keeps every row in
        # shared memory at the default launch
        G = port.blocks_per_warp(4096, sms)
        assert port.enc_pool_rows(71, 4096, G, port.ENC_CHUNK, port.ENC_RING,
                                  smem_per_sm, sms) >= 5


def test_blocks_per_warp_rule():
    prev = 1
    for B in (1, 5, 130, 528, 529, 1024, 4096, 16896, 10**6):
        G = port.blocks_per_warp(B, 132)
        assert 1 <= G <= 32 and G >= prev
        assert G == 32 or -(-B // G) <= 4 * 132
        assert G == 1 or -(-B // (G // 2)) > 4 * 132
        prev = G
    assert port.blocks_per_warp(4096, 132) == 8


def test_enc_launch_arguments_leave_the_plain_version_alone():
    """On CPU tensors the launch arguments change nothing (the plain
    version runs); values the kernel cannot take are refused."""
    blocks, lens, ms = testdata.arith_blocks(3, 40, 6, seed=9)
    bt, lt, mt = (torch.from_numpy(x) for x in (blocks, lens, ms))
    M = int(ms.max())
    want = port.arith_enc(bt, lt, mt, M, 1)
    got = port.arith_enc(bt, lt, mt, M, 1, per_warp=1, pool=1, chunk=1,
                         ring=16)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    for bad in (dict(per_warp=33), dict(pool=M + 1), dict(ring=24),
                dict(ring=8), dict(chunk=-1)):
        with pytest.raises(ValueError):
            port.arith_enc(bt, lt, mt, M, 1, **bad)


def test_encoder_range_step_is_exact_for_every_total():
    """arith_enc.cu's range chain (rc_core.cuh: rc_udiv, rc_range_step)
    in numpy.  r = range // total through the reciprocal kept beside the
    total and one correction, for every total 1..65535 at ranges the
    coder holds: 2^24 (the least after a renormalisation), 2^32 - 1 (the
    start), and multiples of the total and one less.  Then the
    renormalisation as one shift of 0, 8 or 16 bits against RC_Encode's
    two tests."""
    tab = port._recip_table(torch.device("cpu")).numpy().view(np.uint32)
    d = np.arange(1, 65536, dtype=np.uint64)
    m = tab[1:].astype(np.uint64)
    k = (np.uint64(0xFFFFFFFF) // d) // np.uint64(3) + np.uint64(1)
    for n in (np.full_like(d, 1 << 24), np.full_like(d, 0xFFFFFFFF),
              d * k, d * k - np.uint64(1), d * (k + np.uint64(1))):
        n = np.maximum(n, d)
        q = (n * m) >> np.uint64(32)
        r = q + (n - q * d >= d)
        np.testing.assert_array_equal(r, n // d)
    rng = np.random.default_rng(5)
    rg = np.concatenate([rng.integers(0, 1 << 32, 100000, dtype=np.uint64),
                         np.arange(0, 1 << 17, 7, dtype=np.uint64),
                         np.array([0, (1 << 16) - 1, 1 << 16, (1 << 24) - 1,
                                   1 << 24], np.uint64)])
    ns = (rg < (1 << 24)).astype(np.uint64) + (rg < (1 << 16))
    got = (rg << (np.uint64(8) * ns)) & np.uint64(0xFFFFFFFF)
    want, shifts = rg.copy(), np.zeros_like(rg)
    for _ in range(2):
        low = want < (1 << 24)
        want = np.where(low, (want << np.uint64(8)) & np.uint64(0xFFFFFFFF),
                        want)
        shifts += low
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ns, shifts)
