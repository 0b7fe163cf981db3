"""Blocks of different lengths through a reference that codes a (B, n)
array: one call per length, the answers put back in the blocks'
order."""

from __future__ import annotations

import numpy as np


def by_length(fn, blocks) -> list:
    """``fn((B, n) uint8) -> list`` over ``blocks`` (a list of uint8
    arrays of any lengths), grouped by length."""
    groups: dict[int, list[int]] = {}
    for i, b in enumerate(blocks):
        groups.setdefault(len(b), []).append(i)
    out = [None] * len(blocks)
    for idx in groups.values():
        for i, r in zip(idx, fn(np.stack([blocks[i] for i in idx]))):
            out[i] = r
    return out
