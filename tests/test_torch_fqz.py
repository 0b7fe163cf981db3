"""The port's fqzcomp_qual codec (models/fqz.py) against the JAX
package's: the host codec on a spread of record layouts and flags, and
the batched device encode (host replay + the rc_enc plain version on
device="cpu") against the JAX package's (Pallas kernel in interpret
mode).  Exact equality throughout."""

import numpy as np
import pytest

from htscodecs_tpu import native as ref_native
from htscodecs_tpu.models import fqz as ref_fqz
from htscodecs_tpu_torch import native as port_native
from htscodecs_tpu_torch.models import fqz as port_fqz
from htscodecs_tpu_torch.ops import rans_vmem
from htscodecs_tpu_torch.utils import testdata

pytestmark = pytest.mark.skipif(
    not (ref_native.available() and port_native.available()),
    reason="native host kernels unavailable")


def _job(case):
    rng = np.random.default_rng(len(case))
    if case == "fixed":
        lens = [50] * 40
        flags = [0] * 40
    elif case == "variable":
        lens = rng.integers(20, 90, 40).tolist()
        flags = [0] * 40
    elif case == "read2_reverse":
        lens = [75] * 60
        flags = [(128 if i & 1 else 0) | (16 if i % 3 == 0 else 0)
                 for i in range(60)]
    elif case == "duplicates":
        lens = [30] * 80
        flags = [0] * 80
    else:                                   # many symbols, no quality map
        lens = [100] * 50
        flags = [0] * 50
    n = sum(lens)
    if case == "wide":
        data = rng.integers(33, 74, n).astype(np.uint8)
    else:
        data = testdata.synth_fqz_jobs(1, 1, n, seed=len(case))[0][0].copy()
    if case == "duplicates":
        data[30:60] = data[0:30]
        data[90:120] = data[60:90]
    return data, lens, flags


CASES = ["fixed", "variable", "read2_reverse", "duplicates", "wide"]


@pytest.mark.parametrize("strat", [0, 1, 2, 3])
@pytest.mark.parametrize("case", CASES)
def test_compress_and_decompress_equal_the_reference(case, strat):
    data, lens, flags = _job(case)
    mine = port_fqz.compress(data, lens, list(flags), strat=strat)
    assert mine == ref_fqz.compress(data, lens, list(flags), strat=strat)
    assert port_fqz.decompress(mine) == data.tobytes()
    assert port_fqz.decompress(mine, with_lengths=True) == \
        ref_fqz.decompress(mine, with_lengths=True)


def test_version_3_reverses_records_as_the_reference():
    data, lens, flags = _job("read2_reverse")
    mine = port_fqz.compress(data, lens, list(flags), vers=3)
    assert mine == ref_fqz.compress(data, lens, list(flags), vers=3)
    assert port_fqz.decompress(mine) == data.tobytes()


def test_pure_python_coder_equals_the_native_one(monkeypatch):
    data, lens, flags = _job("fixed")
    native = port_fqz.compress(data, lens, list(flags))
    monkeypatch.setenv("HTSCODECS_TORCH_NATIVE", "0")
    assert port_fqz.compress(data, lens, list(flags)) == native
    assert port_fqz.decompress(native) == data.tobytes()
    # the batched encode has no pure-Python replay: it says so
    with pytest.raises(RuntimeError, match="native host library"):
        port_fqz.compress_batch_device([(data, lens)], device="cpu")


def test_corrupt_stream_is_rejected():
    with pytest.raises(ValueError):
        port_fqz.decompress(b"\x05" + bytes(12))


def test_batch_device_equals_the_reference(monkeypatch):
    """tests/test_rc_vmem.py's batched case: the JAX side runs its
    Pallas kernel in interpret mode (per_r=8)."""
    from htscodecs_tpu.ops import rans_v2 as ref_rans_v2
    monkeypatch.setattr(ref_rans_v2, "_vmem_engine_ok", lambda: True)
    rng = np.random.default_rng(11)
    jobs = [(rng.integers(28 + b, 42, (3 * 18,)).astype(np.uint8),
             [18] * 3, [0] * 3) for b in range(2)]
    want = ref_fqz.compress_batch_device(
        [(d, l, list(f)) for d, l, f in jobs], per_r=8, interpret=True)
    assert want is not None
    rans_vmem.reset_launches()
    got = port_fqz.compress_batch_device(
        [(d, l, list(f)) for d, l, f in jobs], device="cpu")
    assert got == want == [port_fqz.compress(d, l, f) for d, l, f in jobs]
    assert not any(rans_vmem.LAUNCHES.values())     # no kernel on the CPU


@pytest.mark.parametrize("case", CASES)
def test_batch_device_equals_the_host_coder(case):
    jobs = [_job(case), _job("fixed")]
    got = port_fqz.compress_batch_device(jobs, device="cpu")
    assert got == [port_fqz.compress(*j) for j in jobs]


def test_batch_device_strips_the_selector_from_the_callers_flags():
    """compress() strips the selector bits it packed into a caller's
    flag list; the batched entry keeps that side effect."""
    data, lens, _ = _job("fixed")
    flags = [(1 << 16) | 128] * len(lens)
    mine = port_fqz.compress_batch_device([(data, lens, flags)], device="cpu")
    assert flags == [128] * len(lens)
    ref_flags = [(1 << 16) | 128] * len(lens)
    assert mine == [ref_fqz.compress(data, lens, ref_flags)]
    assert ref_flags == flags
