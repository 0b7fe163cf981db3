"""The direct route of the rANS 4x16 decoder's base-row entry
(htscodecs_tpu_torch.ops.rans_vmem, csrc/rans16_dec.cu:
rans16_dec_direct_kernel) in plain form: the fused slot table its
prologue fills, the rows and shapes it refuses, and the rule that picks
it.  The kernel itself runs only on the card (chip_smoke.py holds it
against the bisection route and the plain version there)."""

import numpy as np
import pytest
import torch

from htscodecs_tpu_torch.ops import convert, rans_v2
from htscodecs_tpu_torch.ops import rans_vmem as v
from htscodecs_tpu_torch.utils import testdata

# an H100 SXM: 132 SMs, 227 KB a CTA may opt into, 228 KB an SM
H100 = (132, 232448, 233472)


def _slot_values(rows, shift):
    """Each slot's (symbol, base, freq) by ``_rans16_dec_plain``'s lookup
    (base-row answers) over rows (R, A+1): three (R, 1 << shift) int64
    arrays."""
    R, A1 = rows.shape
    n = 1 << shift
    m = torch.arange(n).expand(R, -1)
    wide = rows.to(torch.int64)[:, None, :].expand(R, n, A1)
    return [t.numpy() for t in v._slot_lookup(wide, m)]


def _unpacked(words, shift):
    """The kernel's field extraction: words (R, 1 << shift) -> (symbol,
    base, freq), base = slot - (slot - base)."""
    m = torch.arange(1 << shift)
    sym = (words >> v.DIRECT_S_SHIFT) & 0x7F
    return [t.numpy() for t in (sym, m - (words & 0xFFF),
                                words >> v.DIRECT_F_SHIFT)]


def _rows(kind, shift):
    """Base rows (R, A+1) int16 of the kinds the fill must answer as the
    bisection route does: the tables the batch layer builds (holes and
    unused, empty contexts included), freq-0 entries between used ones,
    rows whose first base lies past slot 0 (slots with no base at or
    below them: freq = row[1]), stored-zero rows (every entry 0: the last
    entry with freq 0) and one-symbol rows that take every slot."""
    T = 1 << shift
    rng = np.random.default_rng(shift)
    if kind in ("tables_o1", "tables_o0"):
        order = int(kind[-1])
        blocks = testdata.synth_wide(5, 700, 6, seed=3)
        alpha, packed, _A = testdata.synth_tables(blocks, shift, order)
        bases = convert.tables_from_reference(alpha, packed, shift,
                                              "cpu").bases
        return bases.reshape(-1, bases.shape[-1])
    if kind == "freq0":
        pk = np.zeros((24, 9), np.int32)
        for r in range(24):
            used = np.sort(rng.choice(9, size=int(rng.integers(1, 9)),
                                      replace=False))
            cuts = np.sort(rng.integers(1, T, len(used) - 1))
            fq = np.diff(np.concatenate([[0], cuts, [T]]))
            keep = fq > 0
            used, fq = used[keep], fq[keep]
            bs = np.concatenate([[0], np.cumsum(fq)[:-1]])
            pk[r, used] = bs << 13 | fq
        return rans_v2._b16_fill(torch.from_numpy(pk)[:, None, :], shift) \
            .to(torch.int16).reshape(24, -1)
    if kind == "no_base":
        # monotone rows whose first entry lies past slot 0
        rows = [np.sort(rng.integers(1, T + 1, A + 1)) for A in (1, 3, 8, 40)]
        rows += [np.array([T // 2, T // 2, T], np.int64),
                 np.full(5, T, np.int64)]           # an empty context row
        return [torch.from_numpy(r.astype(np.int16))[None] for r in rows]
    if kind == "stored_zero":
        return torch.zeros((3, 9), dtype=torch.int16)
    # one symbol takes every slot: freq 1 << shift
    return torch.tensor([[0, T, T, T], [0, 0, T, T], [0, 0, 0, T]],
                        dtype=torch.int16)


@pytest.mark.parametrize("shift", [10, 12])
@pytest.mark.parametrize("kind", ["tables_o1", "tables_o0", "freq0",
                                  "no_base", "stored_zero", "one_symbol"])
def test_direct_table_gives_every_slot_the_lookup_of_the_plain_version(
        kind, shift):
    """The fused word of each slot unpacks to the (symbol, base,
    frequency) that _rans16_dec_plain's lookup gives that slot."""
    groups = _rows(kind, shift)
    for rows in groups if isinstance(groups, list) else [groups]:
        words = v._direct_table16_plain(rows, shift)
        assert words is not None
        assert words.shape == (rows.shape[0], 1 << shift)
        for got, want in zip(_unpacked(words, shift),
                             _slot_values(rows, shift)):
            np.testing.assert_array_equal(got, want)


def test_direct_table_answers_of_the_edge_kinds():
    """The answers the edge kinds must give, spelled out: no base at or
    below the slot gives symbol 0, base 0 and freq row[1]; a stored-zero
    row gives its last symbol with freq 0; a one-symbol row freq 4096."""
    rows = torch.tensor([[100, 300, 1024], [0, 0, 0], [0, 4096, 4096]],
                        dtype=torch.int16)
    w = v._direct_table16_plain(rows, 12)
    sym, bs, f = _unpacked(w, 12)
    assert (sym[0, 5], bs[0, 5], f[0, 5]) == (0, 0, 300)
    assert (sym[0, 200], bs[0, 200], f[0, 200]) == (0, 100, 200)
    assert (sym[0, 4000], bs[0, 4000], f[0, 4000]) == (1, 300, 724)
    assert (sym[1] == 1).all() and (bs[1] == 0).all() and (f[1] == 0).all()
    assert (sym[2] == 0).all() and (f[2] == 4096).all()


@pytest.mark.parametrize("row", [[-1, 0, 1024], [0, 4097, 4097],
                                 [0, 3000, 2000], [0, -32768, 4096],
                                 [5, 4, 1024], [0, 100, 4096, 4095]])
def test_direct_table_refuses_rows_the_word_cannot_hold(row):
    """A negative entry, one past 4096 or a row that falls (int16 wraps
    of a corrupt parse): the launch takes the bisection route."""
    rows = torch.tensor([[0, 512, 1024], row[:3]], dtype=torch.int16) \
        if len(row) == 3 else torch.tensor([row], dtype=torch.int16)
    assert not v._rows_packable(rows)
    assert v._direct_table16_plain(rows, 10) is None


@pytest.mark.parametrize("shift", [0, 13, 14, 15])
def test_direct_table_refuses_shifts_past_its_slot_field(shift):
    rows = torch.tensor([[0, 1, 2]], dtype=torch.int16)
    assert v._rows_packable(rows)
    assert v._direct_table16_plain(rows, shift) is None
    assert not v.direct_route(16, 8, 1, shift, *H100)


def test_direct_table_refuses_alphabets_past_its_symbol_field():
    ok = torch.arange(129, dtype=torch.int16)[None] * 30
    assert v._rows_packable(ok)
    assert v._direct_table16_plain(ok, 12) is not None               # A 128
    wide = torch.arange(130, dtype=torch.int16)[None] * 30
    assert v._rows_packable(wide)
    assert v._direct_table16_plain(wide, 12) is None                 # A 129


@pytest.mark.parametrize("B,A,order,shift,kw,want", [
    (16, 8, 1, 10, {}, True),       # the read cell: 16 blocks, A = 8
    (1, 8, 1, 10, {}, True),
    (792, 8, 1, 10, {}, True),      # six CTAs an SM: one wave
    (793, 8, 1, 10, {}, False),
    (4096, 8, 1, 10, {}, False),
    (1320, 5, 1, 10, {}, True),     # ten an SM at A = 5
    (1321, 5, 1, 10, {}, False),
    (396, 55, 1, 10, {}, True),     # the widest order-1 CTA at shift 10
    (397, 55, 1, 10, {}, False),
    (1, 56, 1, 10, {}, False),
    (16, 8, 1, 12, {}, True),       # one CTA an SM: three blocks in turns
    (396, 8, 1, 12, {}, True),
    (397, 8, 1, 12, {}, False),
    (528, 8, 1, 12, {}, False),
    (16, 14, 1, 12, {}, True),      # the widest order-1 CTA at shift 12
    (16, 15, 1, 12, {}, False),
    (16, 8, 1, 13, {}, False),      # past the word's slot field
    (1584, 8, 0, 12, {}, True),     # order 0: twelve an SM
    (1585, 8, 0, 12, {}, False),
    (1584, 5, 0, 10, {}, True),     # sixteen would fit: the registers
    (1585, 5, 0, 10, {}, False),    # allow twelve
    (16, 128, 0, 12, {}, True),
    (16, 129, 0, 12, {}, False),    # past the word's symbol field
    (16, 128, 1, 10, {}, False),    # 128 rows of 4 KB do not fit
    (0, 8, 1, 10, {}, False),
    (16, 8, 1, 10, dict(threads=32), False),
    (16, 8, 1, 10, dict(threads=128), False),
    (16, 8, 0, 12, dict(threads=64), False),
    (16, 8, 1, 10, dict(global_tables=True), False),
])
def test_direct_route_rule(B, A, order, shift, kw, want):
    """The direct route takes default launches whose CTA fits, whose
    shift and alphabet fit the word and that leave an SM at most three
    blocks, or one wave where more CTAs fit on an SM at once; an
    explicit CTA size or the global-table route keeps the bisection
    route."""
    assert v.direct_route(B, A, order, shift, *H100, **kw) is want


@pytest.mark.parametrize("shift", range(1, 10))
def test_direct_route_refuses_shifts_below_the_formats(shift):
    """Shifts 1 to 9, which the format never gives (order 0: 12; order
    1: 10 or 12), keep the bisection route at any B, alphabet and order,
    though their rows would fit more CTAs an SM than shift 10's."""
    for order in (0, 1):
        for B, A in ((1, 2), (16, 8), (792, 8), (1584, 5)):
            assert v.direct_ctas_per_sm(A, order, shift, *H100[1:]) > 0
            assert not v.direct_route(B, A, order, shift, *H100)


def test_direct_route_ring_starts_on_16_bytes():
    """The fused rows are rounded up to 16 bytes, so that the ring's
    16-byte copies land aligned at any shift the kernel takes: 3 rows of
    2 slots are 24 bytes, and the ring starts at 32."""
    assert v._direct_smem(3, 1, 1) == 32 + 512 + 32 + 16
    for A in (1, 3, 5, 8):
        for order in (0, 1):
            for shift in range(1, 13):
                assert v._direct_smem(A, order, shift) % 16 == 0


def test_direct_route_cta_sizes():
    """The shared memory the rule counts at the read cell's shapes, the
    CTAs an SM at each alphabet, and one switch from fitting to not at
    each order and shift."""
    assert v._direct_smem(8, 1, 10) == 8 * 4096 + 512 + 144 + 16
    assert v._direct_smem(8, 1, 12) == 8 * 16384 + 512 + 144 + 16
    assert v._direct_smem(8, 0, 12) == 16384 + 512 + 32 + 16
    per_sm = [v.direct_ctas_per_sm(A, 1, 10, *H100[1:]) for A in range(1, 9)]
    assert per_sm == [12, 12, 12, 12, 10, 8, 7, 6]
    per_sm = [v.direct_ctas_per_sm(A, 1, 12, *H100[1:]) for A in range(1, 9)]
    assert per_sm == [12, 6, 4, 3, 2, 2, 2, 1]
    for order in (0, 1):
        for shift in (10, 12):
            fits = [v.direct_route(1, A, order, shift, *H100)
                    for A in range(1, 257)]
            assert fits[0] and fits.count(True) == fits.index(False)


def _tables(B, A, order, shift):
    blocks = testdata.synth_wide(B, 64, max(A - 2, 1), seed=B)
    sv = np.resize(np.asarray(shift, np.int32), B)
    alpha, packed, _A = testdata.synth_tables(blocks, sv, order)
    return convert.tables_from_reference(alpha, packed, sv, "cpu")


@pytest.fixture
def on_h100(monkeypatch):
    monkeypatch.setattr(v, "_device_limits", lambda dev: H100)


@pytest.mark.parametrize("shift,want", [(10, 10), (12, 12), ([10, 12], 12),
                                        ([12, 10, 10], 12), (13, None),
                                        ([10, 13], None), ([0, 10], None),
                                        (1, None), (9, None),
                                        ([9, 12], None)])
def test_direct_shift_sizes_rows_by_the_largest_shift(on_h100, shift, want):
    """The wrapper's choice: the launch's largest shift where every shift
    lies in [10, 12], else the bisection route."""
    t = _tables(6, 8, 1, shift)
    assert v._direct_shift(t, 1, 0, False) == want


def test_direct_shift_keeps_the_bisection_route(on_h100):
    """An explicit CTA, the global-table route, a batch past the rule at
    any shift (its shifts and rows are not read: no host copy) and rows
    the word cannot hold keep the bisection route."""
    t = _tables(6, 8, 1, 10)
    assert v._direct_shift(t, 1, 32, False) is None
    assert v._direct_shift(t, 1, 0, True) is None
    big = convert.Tables(torch.zeros((5000, 8), dtype=torch.uint8),
                         None, None)
    assert v._direct_shift(big, 1, 0, False) is None
    bad = t.bases.clone()
    bad[2, 3, 4] = bad[2, 3, 3] - 1                  # a falling row
    assert v._direct_shift(convert.Tables(t.alpha, bad, t.shift), 1, 0,
                           False) is None


def test_cpu_tensors_take_the_plain_version_on_either_route(on_h100):
    """On the CPU the wrapper returns the plain version and counts no
    launch, whatever route a card would take."""
    blocks = testdata.synth_wide(3, 257, 5, seed=9)
    alpha, packed, _A = testdata.synth_tables(blocks, 10, 1)
    al = torch.from_numpy(alpha)
    pk = torch.from_numpy(packed.reshape(3, -1))
    sv = torch.full((3,), 10, dtype=torch.int32)
    st, wd, cn = v.rans16_enc_packed(torch.from_numpy(blocks), al, pk, sv, 1)
    wd = convert.words_forward(wd, cn).contiguous()
    t = convert.tables_from_packed(al, pk.view(3, *packed.shape[1:]), sv)
    assert v._direct_shift(t, 1, 0, False) == 10
    before = dict(v.LAUNCHES)
    out = v.rans16_dec(st, wd, cn, t, 257, 1)
    assert v.LAUNCHES == before
    np.testing.assert_array_equal(out.numpy(), blocks)
