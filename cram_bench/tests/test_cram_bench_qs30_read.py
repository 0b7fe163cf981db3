"""The CRAM 3.0 read cell ``qs30-read-k16``: rANS 4x8 streams written by
the plain reference, read back through ``batch.r4x8_uncompress_blocks``;
on the CPU at a small size (``bench.run`` with ``device="cpu"``)."""

import ast
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cram_bench.harness import spec
from conftest import ROOT
from htscodecs_tpu_torch.models import batch
from htscodecs_tpu_torch.ops import convert, rans8_vmem
from test_cram_bench_faults import FAULTS, _run

CELL = "qs30-read-k16"


def test_sound_run_is_correct(small_bench):
    r = _run(small_bench, CELL)
    assert r["correct"] is True
    assert r["attempted"] >= 1 and r["failed"] == 0


def test_control_is_not_correct(small_bench):
    r = _run(small_bench, CELL, control=True)
    assert r["correct"] is False
    assert r["checks"]["outputs_wrong"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(small_bench, fault, monkeypatch):
    monkeypatch.setattr(batch, "r4x8_uncompress_blocks",
                        FAULTS[fault](batch.r4x8_uncompress_blocks))
    checks = _run(small_bench, CELL)["checks"]
    assert (checks["outputs_wrong"]["value"]
            + checks["outputs_missing"]["value"]) > 0


def test_the_cell_reports_the_read_metrics():
    cell = spec.load(CELL, ROOT / "BENCHMARK.json")
    assert (cell.config_name, cell.traffic, cell.chips) == (
        "cram30-qs", "read-k16", 1)
    assert cell.config["reduced"] == [] and cell.mix["slices_per_call"] == 16
    assert {m["name"] for m, _r in cell.end_to_end} == {
        "dec_MBps", "dec_call_p95_ms", "setup_s"}
    assert {m["name"] for m, _r in cell.per_layer} == {
        "rans8_dec_roofline", "copy_ms.dec", "entry_self_ms.dec",
        "device_idle_pct.dec"}


def _chip_smoke_dec8_count(B, N, A, nbytes, tables):
    """``chip_smoke.py``'s count of the 4x8 decode in ``kernel_times8``,
    its expressions evaluated as written there."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    (fn,) = [f for f in tree.body if isinstance(f, ast.FunctionDef)
             and f.name == "kernel_times8"]
    exprs = {t.id: node.value for node in ast.walk(fn)
             if isinstance(node, ast.Assign) for t in node.targets
             if isinstance(t, ast.Name)}
    env = {"B": B, "N": N, "A": A, "order": 1, "nbytes": nbytes,
           "tables": tables, "rans8_vmem": rans8_vmem, "math": math}
    for name in ("nq", "dec_bytes", "dec_ops"):
        env[name] = eval(compile(ast.Expression(exprs[name]), "chip_smoke",
                                 "eval"), env)
    return env["dec_bytes"], env["dec_ops"]


@pytest.mark.parametrize("n,alphabet,stream", [(1_510_000, 4, 119_636),
                                               (4001, 7, 1234)])
def test_roofline_work_is_chip_smokes_count(n, alphabet, stream):
    work = spec.load_module(ROOT / "cram_bench/metrics/rans8_dec_roofline.py",
                            "t").work
    A = alphabet + 1
    # the tables of one order-1 block as the decoder gets them
    alpha = np.arange(A, dtype=np.uint8)[None]
    packed = np.ones((1, A, A), np.int32)
    tables = convert.tables8_from_reference(alpha, packed,
                                            torch.device("cpu"))
    assert tables.bases.numel() * tables.bases.element_size() == \
        2 * A * (A + 1)
    assert work(n, alphabet, stream) == _chip_smoke_dec8_count(
        1, n, A, stream, tables)
