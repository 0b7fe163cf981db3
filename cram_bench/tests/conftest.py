"""Tests of the benchmark itself.  CPU tests drive the harness at small
sizes with ``device="cpu"``; tests marked ``card`` run cells on a CUDA
device and skip without one (``pytest cram_bench/tests -m card`` on the
card's machine)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: runs on a CUDA device; skipped without one")


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is there."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's cells run on the card")


# blocks of 4000 bytes, 4 a call: what a CPU test run holds
SMALL = {"reads_per_slice": 40, "read_length": 100}
SMALL_K = 4


# cells whose files are in the benchmark's folder but that
# BENCHMARK.json does not hold yet (PERF.md, Open questions): the tests
# add them back to their copy, so that their files stay tested
LATER = {
    "configs": [{"name": "cram30-qs", "source": "test",
                 "file": "cram_bench/configs/cram30-qs.json",
                 "reduced": [], "why": "test"}],
    "workloads": [{"name": "qs30-write-k256", "config": "cram30-qs",
                   "traffic": "write-k256", "chips": 1, "why": "test"},
                  {"name": "qs31-read-k256", "config": "cram31-normal-qs",
                   "traffic": "read-k256", "chips": 1, "why": "test"}],
    "per_layer": [{"name": "rans8_enc_roofline", "unit": "%",
                   "better": "higher", "source": "device_trace",
                   "layer": "kernels", "moves": "enc_MBps",
                   "workloads": ["qs30-write-k256"]},
                  {"name": "host_tables_ms", "unit": "ms",
                   "better": "lower", "source": "host_clock",
                   "layer": "host tables: native/", "moves": "enc_MBps",
                   "workloads": ["qs30-write-k256"]}],
    "e2e": {"enc_MBps": "qs30-write-k256", "dec_MBps": "qs31-read-k256"},
}


@pytest.fixture
def small_bench(tmp_path):
    """A copy of BENCHMARK.json and the benchmark's folder under
    ``tmp_path`` with every configuration cut to 4000-byte blocks and
    every mix to 4 blocks a call, and the cells of ``LATER`` added.
    Returns (bench file, folder)."""
    here = tmp_path / "cram_bench"
    shutil.copytree(ROOT / "cram_bench", here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        bench[key] += LATER[key]
    for m in bench["end_to_end"]:
        if m["name"] in LATER["e2e"]:
            m["workloads"].append(LATER["e2e"][m["name"]])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for p in (here / "configs").glob("*.json"):
        cfg = json.loads(p.read_text())
        cfg.update(SMALL)
        p.write_text(json.dumps(cfg))
    for p in (here / "mixes").glob("*.json"):
        mix = json.loads(p.read_text())
        mix["slices_per_call"] = SMALL_K
        p.write_text(json.dumps(mix))
    return tmp_path / "BENCHMARK.json", here
