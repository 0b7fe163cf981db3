"""The plain references against the port's host coders.

The tests may import the port; the references may not (see
``test_cram_bench_imports.py``)."""

import numpy as np
import pytest

from cram_bench.ref import rans4x8 as r8
from cram_bench.ref import rans4x16 as r16

from htscodecs_tpu_torch.models import rans4x8, rans4x16


def _batches():
    rng = np.random.default_rng(13)
    for trial in range(12):
        n = int(rng.integers(4, 2500))
        k = int(rng.integers(1, 7))
        syms = rng.choice(np.arange(1, 80), size=k, replace=False)
        p = rng.dirichlet(np.ones(k) * (0.3 if trial % 2 else 3.0))
        yield syms[rng.choice(k, size=(3, n), p=p)].astype(np.uint8)
    # the quality series itself, one run model over a longer block
    import json
    from cram_bench.harness.spec import load_module
    from conftest import ROOT
    gen = load_module(ROOT / "cram_bench/generators/qs_runs.py", "t")
    cfg = json.loads((ROOT / "cram_bench/configs/cram31-normal-qs.json")
                     .read_text())
    yield np.stack(gen.blocks(dict(cfg, reads_per_slice=60), 9, range(2)))


@pytest.mark.parametrize("b", range(13))
def test_rans4x16_reference_equals_and_decodes(b):
    blocks = list(_batches())[b]
    streams = r16.compress_o1(blocks)
    for blk, s in zip(blocks, streams):
        assert s == rans4x16.compress(blk, 1)
        assert rans4x16.uncompress(s) == blk.tobytes()


@pytest.mark.parametrize("b", range(13))
def test_rans4x8_reference_equals_and_decodes(b):
    blocks = list(_batches())[b]
    streams = r8.compress_o1(blocks)
    for blk, s in zip(blocks, streams):
        assert s == rans4x8.compress(blk, 1)
        assert rans4x8.uncompress(s) == blk.tobytes()


def test_rans4x16_cat_fallback_on_incompressible_blocks():
    blocks = np.random.default_rng(3).integers(0, 200, (2, 40), np.uint8)
    streams = r16.compress_o1(blocks)
    for blk, s in zip(blocks, streams):
        assert s[0] == r16.X_CAT
        assert s == rans4x16.compress(blk, 1)


def test_twelve_bit_tables():
    """The quality blocks take 10-bit tables; a dominant symbol among
    rare ones takes 12, and the reference follows the port there too."""
    rng = np.random.default_rng(1)
    p = np.array([0.98] + [0.02 / 19] * 19)
    blk = (np.arange(20) + 3).astype(np.uint8)[rng.choice(20, 200000, p=p)]
    assert r16.tables(blk)[1] == 12
    assert r16.compress_o1(blk[None])[0] == rans4x16.compress(blk, 1)


def test_long_tables_are_refused():
    """Tables over 1000 bytes (htscodecs compresses them) are outside
    what the reference writes: it says so rather than writing a stream
    of its own."""
    blk = np.random.default_rng(2).integers(0, 120, 30000).astype(np.uint8)
    with pytest.raises(ValueError, match="1000 bytes"):
        r16.tables(blk)


@pytest.mark.parametrize("codec", ["rans4x16", "rans4x8"])
def test_blocks_of_different_lengths(codec):
    """A codec file's reference takes blocks of any lengths, each coded
    as it would be alone."""
    from cram_bench.harness.spec import load_module
    from conftest import ROOT
    mod = load_module(ROOT / f"cram_bench/codecs/{codec}.py", "t")
    host = rans4x16 if codec == "rans4x16" else rans4x8
    rng = np.random.default_rng(5)
    blocks = [rng.choice(np.arange(60, 66), size=n).astype(np.uint8)
              for n in (900, 1500, 900, 2100)]
    streams = mod.reference_encode(blocks, {"order": 1})
    assert streams == [host.compress(b, 1) for b in blocks]
