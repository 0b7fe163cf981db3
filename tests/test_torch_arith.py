"""The port's range coder (ops/range_coder.py) and arith_dynamic host
codec (models/arith.py) against the JAX package's on the same inputs:
integer codecs, so every comparison is exact."""

import numpy as np
import pytest

from htscodecs_tpu.models import arith as ref_arith
from htscodecs_tpu.ops import range_coder as ref_rc
from htscodecs_tpu_torch.models import arith as port_arith
from htscodecs_tpu_torch.ops import range_coder as port_rc
from htscodecs_tpu_torch.utils import testdata

# every flag combination tests/test_arith.py uses, and X_EXT
ORDERS = [0, 1, 64, 65, 128, 129, 192, 193, 8, 9, 4]


def _cases(seed):
    rng = np.random.default_rng(seed)
    return {
        "empty": b"",
        "one": b"z",
        "short": b"ab" * 4,
        "constant": b"A" * 50,
        "random40": bytes(rng.integers(33, 73, 500, dtype=np.uint8)),
        "runs": bytes(np.repeat(rng.integers(0, 8, 50, dtype=np.uint8) + 60,
                                rng.integers(1, 9, 50)).astype(np.uint8)),
        "bytes256": bytes(rng.integers(0, 256, 301, dtype=np.uint8)),
        "sparse4": bytes(rng.integers(0, 4, 21, dtype=np.uint8) * 80),
        "long": bytes(rng.integers(40, 48, 5000, dtype=np.uint8)),
    }


CASES = _cases(11)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("order", ORDERS)
def test_compress_and_uncompress_equal_the_reference(order, name):
    data = CASES[name]
    arr = np.frombuffer(data, np.uint8)
    mine = port_arith.compress(arr, order)
    assert mine == ref_arith.compress(arr, order)
    if data:
        assert port_arith.uncompress(mine) == data
        assert port_arith.uncompress(mine, len(data)) == \
            ref_arith.uncompress(mine, len(data))


@pytest.mark.parametrize("order", [0, 1, 64, 65])
def test_pure_python_coders_equal_the_native_ones(order, monkeypatch):
    data = np.frombuffer(CASES["runs"], np.uint8)
    native = port_arith.compress(data, order)
    monkeypatch.setenv("HTSCODECS_TORCH_NATIVE", "0")
    assert port_arith.compress(data, order) == native
    assert port_arith.uncompress(native) == data.tobytes()


def test_malformed_streams_as_the_reference():
    for blob in (b"", b"\x08\x10\x00"):
        with pytest.raises(ValueError):
            port_arith.uncompress(blob)
    # truncated payload: the decoder is refused its priming bytes and
    # emits symbol zero
    assert port_arith.uncompress(b"\x00\x05ab") == bytes(5) == \
        ref_arith.uncompress(b"\x00\x05ab")


@pytest.mark.parametrize("which", ["random", "deferred_runs"])
def test_range_encoder_equals_the_reference(which):
    if which == "random":
        acc, f, tot = testdata.random_triples(1, 400, seed=5)[0]
    else:
        acc, f, tot = testdata.ff_run_triples(40)
    mine, ref = port_rc.RangeEncoder(), ref_rc.RangeEncoder()
    deferred = 0
    for a, b, c in zip(acc.tolist(), f.tolist(), tot.tolist()):
        mine.encode(a, b, c)
        ref.encode(a, b, c)
        deferred = max(deferred, mine.ffnum)
    blob = mine.finish()
    assert blob == ref.finish()
    if which == "deferred_runs":
        # the generator keeps its promise: a carry resolves two pending
        # bytes to 0x00, then a long run of pending bytes comes out 0xFF
        assert blob.startswith(bytes.fromhex("00ff0000"))
        assert deferred >= 30 and b"\xff" * 30 in blob


@pytest.mark.parametrize("nsym,max_sym,n", [(256, 7, 300), (256, 256, 400),
                                            (2, 2, 64), (258, 4, 5000)])
def test_simple_model_round_trip_equals_the_reference(nsym, max_sym, n):
    rng = np.random.default_rng(nsym + n)
    syms = (rng.integers(0, max_sym, n) ** 2 % max_sym).tolist()
    mine, ref = port_rc.RangeEncoder(), ref_rc.RangeEncoder()
    mm, rm = (port_rc.SimpleModel(nsym, max_sym),
              ref_rc.SimpleModel(nsym, max_sym))
    for s in syms:
        mm.encode(mine, s)
        rm.encode(ref, s)
    blob = mine.finish()
    assert blob == ref.finish()
    assert (mm.syms, mm.freqs, mm.total) == (rm.syms, rm.freqs, rm.total)
    dec = port_rc.RangeDecoder(blob, 0, len(blob))
    dm = port_rc.SimpleModel(nsym, max_sym)
    assert [dm.decode(dec) for _ in syms] == syms
