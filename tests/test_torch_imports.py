"""The port stands alone: importing it loads neither jax nor the JAX
package, its sources import neither, and its default device is the GPU
(no silent CPU run)."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "htscodecs_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import htscodecs_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "jaxlib"
       or m == "htscodecs_tpu" or m.startswith("htscodecs_tpu.")]
print("MODULES", len(names), "BAD", bad)
"""

_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|htscodecs_tpu)(?![\w])", re.M)


def test_import_loads_no_jax_and_no_reference_package():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("MODULES")][0]
    assert line.endswith("BAD []"), line
    assert int(line.split()[1]) >= 21, line


def _walked():
    import pkgutil
    import htscodecs_tpu_torch as pkg
    return {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                  pkg.__name__ + ".")}


def test_import_walk_reaches_the_rans4x8_modules():
    names = _walked()
    for mod in ("ops.rans8_core", "ops.rans8_v2", "ops.rans8_vmem",
                "models.rans4x8", "ops.convert", "models.batch"):
        assert f"htscodecs_tpu_torch.{mod}" in names


def test_import_walk_reaches_the_range_coder_modules():
    names = _walked()
    for mod in ("ops.range_coder", "ops.arith_vmem", "ops.rc_vmem",
                "models.arith", "models.fqz"):
        assert f"htscodecs_tpu_torch.{mod}" in names


def test_import_walk_reaches_the_device_table_modules():
    names = _walked()
    for mod in ("ops.tables_v2", "ops.rans_pallas"):
        assert f"htscodecs_tpu_torch.{mod}" in names


def test_import_walk_reaches_the_name_codec_and_the_tools():
    names = _walked()
    for mod in ("models.tok3", "tools", "tools._common", "tools.arith",
                "tools.fqz", "tools.rans4x16", "tools.rans4x8",
                "tools.tok3"):
        assert f"htscodecs_tpu_torch.{mod}" in names


def test_import_walk_reaches_the_fuzz_runner():
    assert "htscodecs_tpu_torch.native.fuzz" in _walked()


_FUZZ_SEEDS = """
import sys, tempfile
from pathlib import Path
from htscodecs_tpu_torch.native import fuzz
with tempfile.TemporaryDirectory() as d:
    n = fuzz.write_seeds(Path(d))
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "jaxlib"
       or m == "htscodecs_tpu" or m.startswith("htscodecs_tpu.")]
print("SEEDS", n, "BAD", bad)
"""


def test_fuzz_runner_writes_its_seeds_without_jax():
    """The runner's seed corpus comes from the port's own encoders: making
    it loads neither jax nor the JAX package."""
    r = subprocess.run([sys.executable, "-c", _FUZZ_SEEDS], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("SEEDS")][0]
    assert line.endswith("BAD []"), line


def test_fuzz_harness_includes_the_ports_own_host_kernels():
    """fuzz_native.c fuzzes the copy of hostkernels.c beside it, and no C
    source of the port names the JAX package's files."""
    src = (PKG / "native" / "fuzz_native.c").read_text()
    assert '#include "hostkernels.c"' in src
    assert (PKG / "native" / "hostkernels.c").exists()
    for c in (PKG / "native").glob("*.c"):
        includes = [ln for ln in c.read_text().splitlines()
                    if ln.startswith("#include")]
        assert not any("htscodecs_tpu/" in ln for ln in includes), c


def test_import_walk_reaches_the_parallel_modules():
    names = _walked()
    for mod in ("parallel", "parallel.streaming", "parallel.pipeline",
                "parallel.distributed", "ops.rans_jax"):
        assert f"htscodecs_tpu_torch.{mod}" in names


def _sources():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    return files


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_source_imports_neither(path):
    assert not _FORBIDDEN.search(path.read_text()), path


def test_forbidden_pattern_catches_what_it_should():
    assert _FORBIDDEN.search("import jax\n")
    assert _FORBIDDEN.search("    from jax import lax\n")
    assert _FORBIDDEN.search("from htscodecs_tpu.ops import rans_v2\n")
    assert _FORBIDDEN.search("import htscodecs_tpu\n")
    assert not _FORBIDDEN.search("from htscodecs_tpu_torch import native\n")
    assert not _FORBIDDEN.search("# replaces htscodecs_tpu/ops/rans_vmem.py\n")


@pytest.mark.parametrize("entry", ["compress", "uncompress", "enc", "dec",
                                   "r4x8_compress", "r4x8_uncompress",
                                   "enc8", "dec8",
                                   "arith_compress", "arith_uncompress",
                                   "fqz_compress", "arith_enc_batch",
                                   "arith_dec_batch", "enc_triples_batch",
                                   "tok3_encode", "tok3_decode"])
def test_default_device_without_a_card_raises(entry):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from htscodecs_tpu_torch.models import batch, tok3
    from htscodecs_tpu_torch.ops import arith_vmem, rans8_v2, rans_v2, rc_vmem
    blocks = [np.zeros(64, np.uint8)] * 20
    z = np.zeros((2, 4), np.uint32)
    u16 = np.ones(8, np.uint16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "arith_compress":
            batch.arith_compress_blocks(blocks, 1, engine="device")
        elif entry == "arith_uncompress":
            batch.arith_uncompress_blocks([b"\x00\x40\x01" + bytes(8)])
        elif entry == "fqz_compress":
            batch.fqz_compress_blocks([(np.zeros(64, np.uint8), [64])],
                                      engine="device")
        elif entry == "arith_enc_batch":
            arith_vmem.enc_batch(np.zeros((2, 64), np.uint8), [64, 64],
                                 [1, 1], 0)
        elif entry == "arith_dec_batch":
            arith_vmem.dec_batch([bytes(8)] * 2, [64, 64], [1, 1], 0)
        elif entry == "tok3_encode":
            tok3.encode_names(b"a:1\n", 9)
        elif entry == "tok3_decode":
            tok3.decode_names(tok3.encode_names(b"a:1\n", 9, device="cpu"))
        elif entry == "enc_triples_batch":
            rc_vmem.enc_triples_batch([(u16, u16, u16)])
        elif entry == "compress":
            batch.compress_blocks(blocks, 1, engine="device")
        elif entry == "uncompress":
            batch.uncompress_blocks([b"\x00\x01a"])
        elif entry == "enc":
            rans_v2.enc_o0_batch(np.zeros((2, 64), np.uint8),
                                 np.zeros((2, 4), np.uint8),
                                 np.zeros((2, 4), np.int32))
        elif entry == "dec":
            rans_v2.dec_o0_batch(z, np.zeros((2, 8), np.uint16), 64,
                                 np.zeros((2, 4), np.uint8),
                                 np.zeros((2, 4), np.int32))
        elif entry == "r4x8_compress":
            batch.r4x8_compress_blocks(blocks, 1, engine="device")
        elif entry == "r4x8_uncompress":
            batch.r4x8_uncompress_blocks([bytes(30)])
        elif entry == "enc8":
            rans8_v2.enc_o1_batch(np.zeros((2, 64), np.uint8),
                                  np.zeros((2, 4), np.uint8),
                                  np.zeros((2, 4, 4), np.int32))
        else:
            rans8_v2.dec_o1_batch(z, np.zeros((2, 8), np.uint8), 64,
                                  np.zeros((2, 4), np.uint8),
                                  np.zeros((2, 4, 4), np.int32))


def test_cuda_tensor_never_takes_the_plain_version():
    """The wrappers pick the plain version by the tensor's device only."""
    import inspect
    from htscodecs_tpu_torch.ops import (arith_vmem, rans8_vmem, rans_vmem,
                                         rc_vmem, tables_v2)
    for fn in (rans_vmem.rans16_dec, rans_vmem.rans16_dec_packed,
               rans_vmem.rans16_enc_packed,
               rans8_vmem.rans8_enc, rans8_vmem.rans8_dec,
               arith_vmem.arith_enc, arith_vmem.arith_dec, rc_vmem.rc_enc,
               tables_v2.tables_o1_presence, tables_v2.tables_o1_count):
        src = inspect.getsource(fn)
        assert 'dev.type == "cpu"' in src
        assert "try:" not in src and "except" not in src
        assert src.count("LAUNCHES[") == 1
