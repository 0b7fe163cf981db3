"""The frozen quality generator."""

import json

import numpy as np

from cram_bench.harness import bench, spec
from conftest import ROOT

gen = spec.load_module(ROOT / "cram_bench/generators/qs_runs.py", "t")

CFG = json.loads((ROOT / "cram_bench/configs/cram31-normal-qs.json")
                 .read_text())


def test_block_length_is_a_full_slice():
    assert gen.block_length(CFG) == 10000 * 151 == 1_510_000


def test_shapes_symbols_and_bin_shares():
    cfg = dict(CFG, reads_per_slice=1000)
    b = np.stack(gen.blocks(cfg, 2**31 + 77, range(3)))
    assert b.shape == (3, 151_000) and b.dtype == np.uint8
    assert set(np.unique(b).tolist()) == {2, 12, 23, 37}
    share = np.bincount(b.ravel(), minlength=38)[[2, 12, 23, 37]] / b.size
    assert np.allclose(share, CFG["bin_probs"], atol=0.01)


def test_runs_cover_the_block_with_the_model_lengths():
    cfg = dict(CFG, reads_per_slice=2000)
    b = gen.blocks(cfg, 5, [0])[0]
    edges = np.flatnonzero(np.diff(b)) + 1
    runs = np.diff(np.concatenate([[0], edges, [len(b)]]))
    # a run of the model can merge with the next when both draw one bin,
    # so observed runs are at least as long; the last quarter is no pad
    assert runs.mean() > 4.0
    assert len(np.unique(b[-len(b) // 4:])) == 4


def test_a_block_depends_only_on_seed_and_index():
    cfg = dict(CFG, reads_per_slice=100)
    a = gen.blocks(cfg, 2**33 + 1, [0, 1, 2])
    assert np.array_equal(gen.blocks(cfg, 2**33 + 1, [2])[0], a[2])
    assert not np.array_equal(a[0], a[1])
    assert not np.array_equal(gen.blocks(cfg, 2**33 + 2, [0])[0], a[0])


def test_worker_processes_give_what_this_process_gives():
    from cram_bench.harness import refpool
    cfg = dict(CFG, reads_per_slice=50)
    codec = str(ROOT / "cram_bench/codecs/rans4x16.py")
    job = refpool.Job(codec, str(ROOT / "cram_bench/generators/qs_runs.py"),
                      cfg, 2**31 + 3, range(5))
    here = refpool.run(job, procs=1)
    assert here == refpool.run(job, procs=3)
    assert all(s[0] == 1 for s in here)
    b = gen.blocks(cfg, 2**31 + 3, range(5), threads=4)
    assert np.array_equal(b, gen.blocks(cfg, 2**31 + 3, range(5)))
    assert bench.alphabet_sizes(b) == [4] * 5


def test_lossy_merges_the_lowest_bin():
    cfg = dict(CFG, reads_per_slice=100)
    (b,) = gen.blocks(cfg, 11, [0])
    lo = gen.lossy(b, cfg)
    assert 2 in b and 2 not in lo
    assert np.array_equal(lo[b != 2], b[b != 2])
