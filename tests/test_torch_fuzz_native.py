"""The port's ASan + edge-coverage fuzz harness over its own native host
kernels (htscodecs_tpu_torch/native/fuzz_native.c): build it, seed it
from the port's encoders and run it briefly (longer runs:
``python3 -m htscodecs_tpu_torch.native.fuzz SECONDS``)."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.skipif(shutil.which("gcc") is None, reason="no gcc")
def test_fuzz_harness_builds_and_runs():
    r = subprocess.run(
        [sys.executable, "-m", "htscodecs_tpu_torch.native.fuzz", "5",
         "8192"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "fuzz_native:" in r.stdout


def test_seed_corpus_puts_every_new_selector_behind_its_byte(tmp_path):
    """The seeds reach the selectors the JAX package's harness lacks:
    the serialised fqz parameter set, the sparse 12-bit header batch and
    the framed tok3 descriptors, and one of each codec's streams."""
    from htscodecs_tpu_torch.native import fuzz
    n = fuzz.write_seeds(tmp_path)
    sels = sorted({p.read_bytes()[0] for p in tmp_path.iterdir()})
    assert n == len(list(tmp_path.iterdir()))
    for sel in (fuzz.SEL_R16_O0, fuzz.SEL_R16_O1, fuzz.SEL_ARITH,
                fuzz.SEL_ARITH + 3, fuzz.SEL_FQZ, fuzz.SEL_FQZ_PARAMS,
                fuzz.SEL_SPARSE12, fuzz.SEL_ARITH_CAPPED, fuzz.SEL_TOK3):
        assert sel in sels, sel
