"""The command-line tools of htscodecs_tpu_torch against the JAX
package's, in process through ``main(argv)``: the same seeded input
file, identical output files, in raw and framed modes, for compress
and ``-d``."""

import importlib

import numpy as np
import pytest

from htscodecs_tpu import native as ref_native
from htscodecs_tpu_torch.utils import testdata

pytestmark = pytest.mark.skipif(not ref_native.available(),
                                reason="native host kernels unavailable")


def _qual(n=24000, seed=19):
    rng = np.random.default_rng(seed)
    q = testdata.synth_quality(1, n, seed)[0]
    q[rng.integers(0, n, n // 50)] = 33 + 30      # a few outliers
    return q.tobytes()


def _fqz_lines(seed=23):
    """fqz tool input: one quality string per line, ASCII-33 shifted,
    with an is_read2 flag on some lines and a selector on others."""
    rng = np.random.default_rng(seed)
    q = testdata.synth_quality(1, 200 * 60, seed)[0].reshape(200, 60)
    lines = []
    for k, row in enumerate(q):
        s = row[:int(rng.integers(30, 61))].tobytes()
        if k % 3 == 1:
            s += b" 1"
        elif k % 3 == 2:
            s += b"\t0 1"
        lines.append(s)
    return b"\n".join(lines) + b"\n"


def _run(pkg, tool, args, data, tmp_path, tag):
    mod = importlib.import_module(f"{pkg}.tools.{tool}")
    src = tmp_path / f"{tag}.in"
    dst = tmp_path / f"{tag}.{pkg}.out"
    src.write_bytes(data)
    assert mod.main([*args, str(src), str(dst)]) == 0
    return dst.read_bytes()


def _both(tool, args, data, tmp_path, tag, port_extra=()):
    """Runs the port's tool and the JAX package's on the same input and
    asserts equal outputs; returns the output."""
    got = _run("htscodecs_tpu_torch", tool, [*args, *port_extra], data,
               tmp_path, tag)
    want = _run("htscodecs_tpu", tool, args, data, tmp_path, tag)
    assert got == want, (tool, args)
    return got


@pytest.mark.parametrize("framed", [False, True], ids=["raw", "framed"])
@pytest.mark.parametrize("order", ["1", "193", "8.4"])
def test_rans4x16(order, framed, tmp_path):
    data = _qual()
    mode = ["-b", "7000"] if framed else ["-r"]
    blob = _both("rans4x16", [*mode, "-o", order], data, tmp_path, "c")
    out = _both("rans4x16", ["-d"] + ([] if framed else ["-r"]), blob,
                tmp_path, "d")
    assert out == data


@pytest.mark.parametrize("framed", [False, True], ids=["raw", "framed"])
def test_rans4x8(framed, tmp_path):
    """Framed mode carries the reference tool's per-block order byte; the
    last block of 3 bytes drops to order 0."""
    data = _qual(n=9003)
    mode = ["-b", "3000"] if framed else ["-r"]
    blob = _both("rans4x8", [*mode, "-o", "1"], data, tmp_path, "c")
    if framed:
        assert blob[0] == 1
    out = _both("rans4x8", ["-d"] + ([] if framed else ["-r"]), blob,
                tmp_path, "d")
    assert out == data


@pytest.mark.parametrize("framed", [False, True], ids=["raw", "framed"])
def test_arith(framed, tmp_path):
    data = _qual(n=12000)
    mode = ["-b", "5000"] if framed else ["-r"]
    blob = _both("arith", [*mode, "-o", "65"], data, tmp_path, "c")
    out = _both("arith", ["-d"] + ([] if framed else ["-r"]), blob,
                tmp_path, "d")
    assert out == data


@pytest.mark.parametrize("framed", [False, True], ids=["raw", "framed"])
def test_fqz(framed, tmp_path, capsys):
    raw = _fqz_lines()
    mode = [] if framed else ["-r"]
    blob = _both("fqz", [*mode, "-s", "2"], raw, tmp_path, "c")
    capsys.readouterr()
    dumped = _both("fqz", [*mode, "-s", "2", "-D"], raw, tmp_path, "cD")
    assert dumped == blob
    err = capsys.readouterr().err
    assert err.count("Global params = {") == 2      # port, then JAX
    port_err = err.split("Total output")[0]
    assert "Global params = {" in port_err and "Param[0] = {" in port_err
    out = _both("fqz", ["-d", "-D", *mode], blob, tmp_path, "d")
    assert capsys.readouterr().err.count("Global params = {") == 2
    want = b"".join(line.replace(b"\t", b" ").split(b" ")[0] + b"\n"
                    for line in raw.split(b"\n") if line)
    assert out == want


@pytest.mark.parametrize("framed", [False, True], ids=["raw", "framed"])
@pytest.mark.parametrize("level", ["-7", "-19"])
def test_tok3(level, framed, tmp_path, monkeypatch):
    """The bare -<digits> level flag; framed mode cuts the input into
    1 MiB chunks at the last whole name (lowered here to 8 KiB in both
    tools, so that the input makes several chunks)."""
    import htscodecs_tpu.tools.tok3 as ref_tool
    import htscodecs_tpu_torch.tools.tok3 as port_tool
    data = testdata.synth_names(600, "illumina", 4)
    monkeypatch.setattr(ref_tool, "BLK", 8192)
    monkeypatch.setattr(port_tool, "BLK", 8192)
    mode = [] if framed else ["-r"]
    dev = ("--device", "cpu")
    blob = _both("tok3", [*mode, level], data, tmp_path, "c", dev)
    if framed:
        assert int.from_bytes(blob[:4], "little") < len(blob) - 4
    out = _both("tok3", ["-d", *mode], blob, tmp_path, "d", dev)
    assert out == data.replace(b"\n", b"\x00")


def test_tok3_default_device_without_a_card_raises(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run("htscodecs_tpu_torch", "tok3", ["-r", "-7"], b"a:1\n",
             tmp_path, "x")
