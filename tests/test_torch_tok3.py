"""The tokenise_name3 name codec of htscodecs_tpu_torch (device="cpu")
against the JAX package's: the same seeded name blocks through
``encode_names`` (both descriptor-encode engines) and ``decode_names``,
the Python tokeniser and replay, the native bindings, and the edge
cases of tests/test_tok3.py.  Streams are compared byte for byte."""

import numpy as np
import pytest

from htscodecs_tpu import native as ref_native
from htscodecs_tpu.models import tok3 as ref_tok3
from htscodecs_tpu_torch import native as port_native
from htscodecs_tpu_torch.models import batch as port_batch
from htscodecs_tpu_torch.models import tok3
from htscodecs_tpu_torch.utils import testdata

pytestmark = pytest.mark.skipif(
    not (ref_native.available() and port_native.available()),
    reason="native host kernels unavailable")

RANS_LEVELS = [1, 3, 5, 7, 9]
ARITH_LEVELS = [11, 15, 19]
STYLES = testdata.NAME_STYLES


def _names(style, n=300, seed=7):
    return testdata.synth_names(n, style, seed)


def _split(lvl):
    return (lvl - 10, True) if lvl > 10 else (lvl, False)


def _reset_counts():
    for side in port_batch.ENTROPY_JOBS.values():
        for k in side:
            side[k] = 0
    for k in port_batch.TABLE_ROUTES:
        port_batch.TABLE_ROUTES[k] = 0


@pytest.mark.parametrize("lvl", RANS_LEVELS + ARITH_LEVELS)
@pytest.mark.parametrize("style", STYLES)
def test_encode_and_decode_equal_the_reference(style, lvl):
    blk = _names(style)
    level, use_arith = _split(lvl)
    want = ref_tok3.encode_names(blk, level, use_arith, engine="host")
    got = tok3.encode_names(blk, level, use_arith, engine="host",
                            device="cpu")
    assert got == want
    out = tok3.decode_names(want, device="cpu")
    assert out == ref_tok3.decode_names(want)
    assert out == blk.replace(b"\n", b"\x00")


@pytest.mark.parametrize("lvl", RANS_LEVELS)
@pytest.mark.parametrize("style", STYLES)
def test_device_engine_equals_the_reference_host_engine(style, lvl):
    """Every (descriptor, candidate) payload of 32 bytes or more goes to
    a batched group of the one 4x16 encoder's plain version."""
    blk = _names(style, n=200, seed=11)
    _reset_counts()
    got = tok3.encode_names(blk, lvl, engine="device", device="cpu")
    assert got == ref_tok3.encode_names(blk, lvl, engine="host")
    assert port_batch.ENTROPY_JOBS["encode"]["device"] > 0


def test_engine_default_is_the_host_and_the_environment_moves_it(
        monkeypatch):
    blk = _names("illumina", n=200)
    monkeypatch.delenv("HTSCODECS_TORCH_TOK3_ENC_ENGINE", raising=False)
    _reset_counts()
    a = tok3.encode_names(blk, 9, device="cpu")
    assert port_batch.ENTROPY_JOBS["encode"] == {"device": 0, "host": 0}
    monkeypatch.setenv("HTSCODECS_TORCH_TOK3_ENC_ENGINE", "device")
    b = tok3.encode_names(blk, 9, device="cpu")
    assert port_batch.ENTROPY_JOBS["encode"]["device"] > 0
    assert a == b


def test_device_tables_route(monkeypatch):
    """TABLES_DEVICE_MIN patched down: the descriptor groups of 2 jobs
    or more build their tables with ops/tables_v2 (the device-table
    route), and the streams stay the reference's."""
    monkeypatch.setattr(port_batch, "TABLES_DEVICE_MIN", 2)
    blk = _names("illumina", n=400, seed=3)
    _reset_counts()
    got = tok3.encode_names(blk, 9, engine="device", device="cpu")
    assert port_batch.TABLE_ROUTES["device"] > 0
    assert got == ref_tok3.encode_names(blk, 9, engine="host")


def test_decode_through_the_batched_decoder(monkeypatch):
    """The size thresholds patched to 0: every rANS descriptor stream of
    32 bytes or more is decoded by the decoder's plain version."""
    blk = _names("pacbio", n=400, seed=5)
    blob = ref_tok3.encode_names(blk, 9)
    monkeypatch.setattr(port_batch, "DEVICE_MIN_GROUP", 1)
    monkeypatch.setattr(port_batch, "DEVICE_MIN_BYTES", 0)
    _reset_counts()
    assert tok3.decode_names(blob, device="cpu") == blk.replace(b"\n", b"\0")
    assert port_batch.ENTROPY_JOBS["decode"]["device"] > 0


def test_default_decode_keeps_a_name_block_on_the_host():
    """Under "auto", a block of 10 000 names sends no descriptor group
    to the batched decoder (DEVICE_MIN_GROUP / DEVICE_MIN_BYTES)."""
    blk = testdata.synth_names(10000, "illumina", 1)
    blob = ref_tok3.encode_names(blk, 9)
    _reset_counts()
    assert tok3.decode_names(blob, device="cpu") == blk.replace(b"\n", b"\0")
    assert port_batch.ENTROPY_JOBS["decode"]["device"] == 0
    assert port_batch.ENTROPY_JOBS["decode"]["host"] > 0


@pytest.mark.parametrize("lvl", [5, 9, 19])
@pytest.mark.parametrize("style", ["illumina", "zeros"])
def test_python_tokeniser_and_replay(style, lvl, monkeypatch):
    """Both native switches off: the Python tokeniser and token replay of
    each package give the streams and names of the native ones."""
    blk = _names(style, n=150, seed=9)
    level, use_arith = _split(lvl)
    native_blob = tok3.encode_names(blk, level, use_arith, device="cpu")
    monkeypatch.setenv("HTSCODECS_TORCH_NATIVE", "0")
    monkeypatch.setattr(ref_tok3, "_USE_NATIVE", False)
    got = tok3.encode_names(blk, level, use_arith, device="cpu")
    assert got == ref_tok3.encode_names(blk, level, use_arith)
    assert got == native_blob
    assert tok3.decode_names(got, device="cpu") == ref_tok3.decode_names(got)


def test_partial_name_carry():
    blk = b"read1:100\nread1:101\nread1:1"
    blob, last_start = tok3.encode_names(blk, 9, False,
                                         return_last_start=True, device="cpu")
    assert (blob, last_start) == ref_tok3.encode_names(
        blk, 9, False, return_last_start=True)
    assert last_start == 20
    assert tok3.decode_names(blob, device="cpu") == \
        b"read1:100\x00read1:101\x00"


@pytest.mark.parametrize("blob", [b"", bytes(8), b"\xff" * 16])
def test_malformed_rejected(blob):
    with pytest.raises(ValueError):
        tok3.decode_names(blob, device="cpu")
    with pytest.raises(ValueError):
        ref_tok3.decode_names(blob)


@pytest.mark.parametrize("blk", [b"a:1\n\nb:2\n", b"nam\xc3e1\n", b"x\n",
                                 b"".join(b"dupname:77\n"
                                          for _ in range(500))],
                         ids=["empty_name", "8bit_separator", "single",
                              "500_dups"])
def test_edge_blocks(blk):
    """Empty names, bytes >= 128 acting as separators, one name, and 500
    equal names (the DUP token and dup descriptor pointers)."""
    for lvl in (9, 19):
        level, use_arith = _split(lvl)
        got = tok3.encode_names(blk, level, use_arith, device="cpu")
        assert got == ref_tok3.encode_names(blk, level, use_arith)
        seps = np.frombuffer(blk, np.uint8)
        want = bytes(np.where((seps <= 10) | (seps >= 128), 0, seps))
        assert tok3.decode_names(got, device="cpu") == want


def test_too_many_tokens_rejected(monkeypatch):
    long_name = b"a1" * 130 + b"\n"
    with pytest.raises(ValueError):
        tok3.encode_names(long_name, 9, False, device="cpu")
    monkeypatch.setenv("HTSCODECS_TORCH_NATIVE", "0")
    with pytest.raises(ValueError, match="too many tokens"):
        tok3.encode_names(long_name, 9, False, device="cpu")


def test_arith_descriptors_decode_against_the_container_remainder(
        monkeypatch):
    """The reference quirk kept: each arith descriptor stream is decoded
    from its payload to the END of the container, not its own clen."""
    blk = _names("sra", n=300)
    blob = tok3.encode_names(blk, 9, True, device="cpu")
    jobs = tok3._parse_container(memoryview(blob))[0]
    seen = []
    real = tok3.arithmod._uncompress_into

    def spy(buf, out_size):
        seen.append(len(buf))
        return real(buf, out_size)

    monkeypatch.setattr(tok3.arithmod, "_uncompress_into", spy)
    assert tok3.decode_names(blob, device="cpu") == ref_tok3.decode_names(blob)
    assert seen == [len(blob) - p2 for _i, p2, _c in jobs]
    assert any(n > clen for n, (_i, _p, clen) in zip(seen, jobs))


def test_corrupt_streams_fail_as_the_reference():
    """Seeded byte flips and truncations: the port decodes to the
    reference's names or raises ValueError where the reference does
    (the native replay declines, the Python replay raises)."""
    rng = np.random.default_rng(13)
    outcomes = set()
    for lvl in (9, 19):
        level, use_arith = _split(lvl)
        blob = ref_tok3.encode_names(_names("illumina", n=60), level,
                                     use_arith)
        for k in range(40):
            b = bytearray(blob)
            if k % 4 == 3:
                b = b[:int(rng.integers(9, len(b)))]
            else:
                for _ in range(int(rng.integers(1, 3))):
                    b[int(rng.integers(9, len(b)))] ^= int(
                        rng.integers(1, 256))
            try:
                want = ("ok", ref_tok3.decode_names(bytes(b)))
            except ValueError:
                want = ("ValueError", None)
            try:
                got = ("ok", tok3.decode_names(bytes(b), device="cpu"))
            except ValueError:
                got = ("ValueError", None)
            assert got == want, (lvl, k)
            outcomes.add(got[0])
    assert outcomes == {"ok", "ValueError"}


@pytest.mark.parametrize("style", STYLES)
def test_native_tokenize_and_detokenize_equal_the_jax_bindings(style):
    blk = _names(style, n=400)
    arr = np.frombuffer(blk, np.uint8)
    seps = np.flatnonzero(arr <= 10)
    starts = np.concatenate([[0], seps[:-1] + 1]).astype(np.int64)
    lens = seps - starts
    got = port_native.tok3_tokenize(blk, starts, lens)
    want = ref_native.tok3_tokenize(blk, starts, lens)
    assert got == want
    desc, max_tok = got
    cap = len(blk) + 16 * (len(seps) + 2) + 1024
    out = port_native.tok3_detokenize(desc, max_tok, len(seps), cap)
    assert out == ref_native.tok3_detokenize(desc, max_tok, len(seps), cap)
    assert out == blk.replace(b"\n", b"\0")
    # a truncated descriptor: both decline
    t0 = min(t for t in desc if t & 15)
    bad = dict(desc)
    bad[t0] = bad[t0][:1]
    assert port_native.tok3_detokenize(bad, max_tok, len(seps), cap) is None
    assert ref_native.tok3_detokenize(bad, max_tok, len(seps), cap) is None
