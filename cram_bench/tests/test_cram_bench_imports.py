"""Nothing the benchmark runs loads JAX or the JAX package, and the
plain references load nothing of the port."""

import ast
import json
import subprocess
import sys

from cram_bench.harness import bench
from conftest import ROOT

BENCH = ROOT / "cram_bench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("htscodecs_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    base = set(bench.loaded_forbidden())
    for name in ("htscodecs_tpu.models.batch", "jaxlib", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
    assert set(bench.loaded_forbidden()) - base == {
        "htscodecs_tpu", "jaxlib", "flax"}


def test_the_references_import_only_numpy_and_the_standard_library():
    for p in sorted((BENCH / "ref").glob("*.py")):
        assert set(_imports(p)) <= {"__future__", "math", "struct",
                                    "numpy"}, p


def test_no_file_of_the_benchmark_imports_jax():
    for p in BENCH.rglob("*.py"):
        names = set(_imports(p))
        assert not names & {"jax", "jaxlib", "flax", "htscodecs_tpu"}, p


def test_a_run_loads_no_jax(small_bench):
    bench_file, here = small_bench
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from cram_bench.harness import bench\n"
        "out = bench.run('qs31-read-k16', 3, 0.2, False, Path(%r),"
        " here=Path(%r), device='cpu', procs=1, log=lambda s: None)\n"
        "print(json.dumps([out['forbidden'], out['result']['correct']]))\n"
        % (str(ROOT), str(bench_file), str(here)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.splitlines()[-1]) == [[], True]


def test_no_result_without_a_card_or_without_the_port(tmp_path):
    """Here there is no CUDA device; in a directory with only the
    benchmark's own files there is no port either."""
    cmd = [sys.executable, "cram_bench/run.py", "--workload",
           "qs31-read-k16", "--seed", "1", "--seconds", "1"]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    import shutil
    shutil.copytree(BENCH, tmp_path / "cram_bench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
