"""qs_runs: quality-series blocks, binned qualities in runs, from a seed.

A frozen, vectorised copy of the model of the port's
``utils/testdata.synth_quality``: each run takes one of the bins with
the configuration's probabilities (0.05 / 0.10 / 0.15 / 0.70 for
Illumina's four RTA3 bins) and a geometric length (p = 0.25) cut at 60.
Three things differ from that function, on purpose: the values are the
raw phred scores that CRAM stores (no +33); runs are drawn until they
fill the whole block (the original draws n / 8 runs and pads the rest
with the last bin); and both draws are read from one 32-bit word per run
through tables quantised at 2**-16 (a block of 1.5 MB takes 10-20 ms).
Block ``i`` of a pool depends only on (seed, i).

A generator file holds ``blocks(cfg, seed, indices, threads)``, a list
of uint8 arrays (of any lengths), and ``lossy(block, cfg)``, the
control's copy of a block with one guarantee of the data broken; a
configuration names its generator under ``"generator"``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

_Q = 1 << 16


def _tables(cfg: dict):
    probs = np.asarray(cfg["bin_probs"], np.float64)
    bins = np.asarray(cfg["quality_bins"], np.uint8)
    u = (np.arange(_Q) + 0.5) / _Q
    value = bins[np.searchsorted(np.cumsum(probs) / probs.sum(), u)]
    p = float(cfg["run_length"]["geometric_p"])
    cap = int(cfg["run_length"]["max"])
    lens = np.arange(1, cap + 1)
    cdf = 1.0 - (1.0 - p) ** lens
    cdf[-1] = 1.0
    length = lens[np.searchsorted(cdf, u)].astype(np.int64)
    mean = float((np.diff(np.concatenate([[0.0], cdf])) * lens).sum())
    return value, length, mean


def block_length(cfg: dict) -> int:
    """One slice's quality-series block: reads per slice x read length."""
    return int(cfg["reads_per_slice"]) * int(cfg["read_length"])


def _seed_words(seed: int) -> list[int]:
    s = int(seed) & ((1 << 64) - 1)
    return [s & 0xFFFFFFFF, s >> 32]


def _block(tabs, n: int, seed: int, index: int) -> np.ndarray:
    value, length, mean = tabs
    rng = np.random.Generator(np.random.PCG64(
        np.random.SeedSequence(_seed_words(seed) + [int(index)])))
    parts, have = [], 0
    while have < n:
        m = int((n - have) / mean) + 64 + 8 * int(np.sqrt(n - have))
        w = rng.integers(0, 1 << 32, size=m, dtype=np.uint32)
        lens = length[w & 0xFFFF]
        parts.append(np.repeat(value[w >> 16], lens))
        have += int(lens.sum())
    out = parts[0] if len(parts) == 1 else np.concatenate(parts)
    return np.ascontiguousarray(out[:n])


def blocks(cfg: dict, seed: int, indices, threads: int = 1) -> list:
    """The blocks at ``indices``, each ``block_length(cfg)`` bytes, made
    over ``threads`` threads (NumPy's draws and copies release the
    lock); rows of one buffer."""
    idx = list(indices)
    n = block_length(cfg)
    tabs = _tables(cfg)
    out = np.empty((len(idx), n), np.uint8)

    def one(k):
        out[k] = _block(tabs, n, seed, idx[k])

    with ThreadPoolExecutor(max(1, threads)) as ex:
        list(ex.map(one, range(len(idx))))
    return list(out)


def lossy(block: np.ndarray, cfg: dict) -> np.ndarray:
    """The control's lossy quality binning: the lowest bin merged into
    the next one (the lossless guarantee broken)."""
    lo, nxt = cfg["quality_bins"][0], cfg["quality_bins"][1]
    out = block.copy()
    out[out == lo] = nxt
    return out
