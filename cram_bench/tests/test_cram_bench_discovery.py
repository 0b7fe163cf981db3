"""A configuration, a traffic mix, a generator of inputs and a
per-layer metric added as new files and new BENCHMARK.json entries,
with no file of the benchmark edited."""

import json

import pytest

from cram_bench.harness import bench, spec

NEW_METRIC = '''"""calls_per_s: calls a second in the window (a test metric)."""


def read(rec):
    t0, t1 = rec.window()
    return len(rec.calls) / (t1 - t0)
'''


def test_new_files_and_entries_only(small_bench):
    bench_file, here = small_bench
    before = {p.relative_to(here): p.read_bytes()
              for p in here.rglob("*") if p.is_file()}
    cfg = json.loads((here / "configs/cram30-qs.json").read_text())
    (here / "configs/cram30-qs-k8test.json").write_text(json.dumps(
        dict(cfg, reads_per_slice=20)))
    (here / "mixes/read-k8test.json").write_text(json.dumps(
        {"direction": "read", "slices_per_call": 8, "pool_batches": 2,
         "loop": "closed", "callers": 1, "checked_calls": 2}))
    (here / "metrics/calls_per_s.py").write_text(NEW_METRIC)
    b = json.loads(bench_file.read_text())
    b["configs"].append({"name": "cram30-qs-k8test", "source": "test",
                         "file": "cram_bench/configs/cram30-qs-k8test.json",
                         "reduced": ["reads_per_slice"], "why": "test"})
    b["workloads"].append({"name": "qs30-read-k8test",
                           "config": "cram30-qs-k8test",
                           "traffic": "read-k8test", "chips": 1,
                           "why": "test"})
    for m in b["end_to_end"]:
        if m["name"] == "dec_MBps":
            m["workloads"].append("qs30-read-k8test")
    b["per_layer"].append({"name": "calls_per_s", "unit": "1/s",
                           "better": "higher", "source": "host_clock",
                           "layer": "entry: models/batch.py",
                           "moves": "dec_MBps",
                           "workloads": ["qs30-read-k8test"]})
    bench_file.write_text(json.dumps(b))

    cell = spec.load("qs30-read-k8test", bench_file, here)
    assert cell.config["reads_per_slice"] == 20 and cell.mix[
        "slices_per_call"] == 8
    assert [m["name"] for m, _r in cell.per_layer] == ["calls_per_s"]
    for trace in (False, True):
        out = bench.run("qs30-read-k8test", 7, 0.2, trace, bench_file,
                        here=here, device="cpu", procs=1,
                        log=lambda s: None)["result"]
        assert out["correct"] is True
        want = {"calls_per_s"} if trace else {"dec_MBps", "setup_s"}
        assert set(out["metrics"]) == want
    for rel, data in before.items():
        assert (here / rel).read_bytes() == data, rel


# not quality scores: words of a small alphabet in blocks of different
# lengths, as the ragged data series of a slice would be
RAGGED = '''"""ragged_words: blocks of 1500-5000 bytes of words (a test generator)."""

import numpy as np

LETTERS = np.frombuffer(b"acgtn ", np.uint8)


def blocks(cfg, seed, indices, threads=1):
    out = []
    for i in indices:
        rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, i])
        n = int(rng.integers(cfg["min_bytes"], cfg["max_bytes"] + 1))
        out.append(LETTERS[rng.choice(6, size=n, p=cfg["p"])])
    return out


def lossy(block, cfg):
    return np.where(block == ord("n"), ord("a"), block).astype(np.uint8)
'''


@pytest.mark.parametrize("direction", ["write", "read"])
def test_ragged_blocks_from_a_generator_of_their_own(small_bench,
                                                     direction):
    bench_file, here = small_bench
    before = {p.relative_to(here): p.read_bytes()
              for p in here.rglob("*") if p.is_file()}
    (here / "generators/ragged_words.py").write_text(RAGGED)
    (here / "configs/words-ragged.json").write_text(json.dumps(
        {"codec": "rans4x16", "order": 1, "generator": "ragged_words",
         "min_bytes": 1500, "max_bytes": 5000,
         "p": [0.3, 0.2, 0.2, 0.2, 0.05, 0.05]}))
    (here / f"mixes/{direction}-k5test.json").write_text(json.dumps(
        {"direction": direction, "slices_per_call": 5, "pool_batches": 2,
         "loop": "closed", "callers": 1, "checked_calls": 2}))
    b = json.loads(bench_file.read_text())
    b["configs"].append({"name": "words-ragged", "source": "test",
                         "file": "cram_bench/configs/words-ragged.json",
                         "reduced": [], "why": "test"})
    cell = f"words-{direction}-k5test"
    b["workloads"].append({"name": cell, "config": "words-ragged",
                           "traffic": f"{direction}-k5test", "chips": 1,
                           "why": "test"})
    metric = "enc_MBps" if direction == "write" else "dec_MBps"
    for m in b["end_to_end"]:
        if m["name"] == metric:
            m["workloads"].append(cell)
    bench_file.write_text(json.dumps(b))

    lines = []
    out = bench.run(cell, 2**31 + 9, 0.2, False, bench_file, here=here,
                    device="cpu", procs=1, log=lines.append)["result"]
    assert out["correct"] is True, lines
    assert set(out["metrics"]) == {metric, "setup_s"}
    # blocks of different lengths, each compared whole
    assert "blocks of 1" in lines[0] and "-" in lines[0].split("blocks of")[1]
    (check,) = [line for line in lines if line.startswith("check: ")]
    assert int(check.split()[1]) in (5, 10)
    ctl = bench.run(cell, 2**31 + 9, 0.2, False, bench_file, here=here,
                    device="cpu", procs=1, control=True,
                    log=lambda s: None)["result"]
    assert ctl["correct"] is False
    for rel, data in before.items():
        assert (here / rel).read_bytes() == data, rel
