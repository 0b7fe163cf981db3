"""htscodecs_tpu_torch.models.rans4x8 (the port's own copy of the
single-block CRAM 3.0 codec, pure Python) against
htscodecs_tpu.models.rans4x8 on the same numpy inputs.  Streams are
compared byte for byte."""

import numpy as np
import pytest

from htscodecs_tpu.models import rans4x8 as ref
from htscodecs_tpu_torch.models import rans4x8 as port


def _distributions():
    rng = np.random.default_rng(17)
    return {
        "constant": np.full(1000, 7, dtype=np.uint8),
        "two_symbols": (rng.integers(0, 2, 999, dtype=np.uint8) * 200 + 1),
        "runs": np.repeat(rng.integers(0, 8, 64, dtype=np.uint8), 97),
        "uniform": rng.integers(0, 256, 2048, dtype=np.uint8),
        "skewed_4095": np.repeat(np.array([3, 9, 200], np.uint8),
                                 [4000, 90, 5]),
    }


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("n", list(range(1, 41)))
def test_edge_sizes_match_the_reference(n, order):
    data = (np.random.default_rng(3 + order + 7 * n)
            .integers(0, 40, n, dtype=np.uint8) + 33)
    want = ref.compress(data, order)
    got = port.compress(data, order)
    assert got == want
    assert port.uncompress(want) == data.tobytes()
    assert ref.uncompress(got) == data.tobytes()


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("name", list(_distributions()))
def test_distributions_match_the_reference(name, order):
    data = _distributions()[name].astype(np.uint8)
    want = ref.compress(data, order)
    assert port.compress(data, order) == want
    assert port.uncompress(want) == data.tobytes()


@pytest.mark.parametrize("order", [0, 1])
def test_empty_block_is_refused_as_in_the_reference(order):
    with pytest.raises(ValueError):
        ref.compress(np.zeros(0, np.uint8), order)
    with pytest.raises(ValueError):
        port.compress(np.zeros(0, np.uint8), order)


@pytest.mark.parametrize("blob", [b"", b"\x02" + bytes(30), bytes(9),
                                  b"\x00" + bytes(30)],
                         ids=["empty", "order2", "short", "zeros"])
def test_malformed_rejected(blob):
    with pytest.raises(ValueError):
        port.uncompress(blob)


@pytest.mark.parametrize("order", [0, 1])
def test_table_build_and_parse_match_the_reference(order):
    data = _distributions()["runs"]
    if order:
        for a, b in zip(port.build_tables_o1(data), ref.build_tables_o1(data)):
            assert np.array_equal(a, b)
    else:
        for a, b in zip(port.build_tables_o0(data), ref.build_tables_o0(data)):
            assert np.array_equal(a, b)
    s = ref.compress(data, order)
    parse_p = port.parse_tables_o1 if order else port.parse_tables_o0
    parse_r = ref.parse_tables_o1 if order else ref.parse_tables_o0
    for a, b in zip(parse_p(s), parse_r(s)):
        assert np.array_equal(a, b)


def test_parse_o1_without_the_slot_table_gives_the_same_tables():
    data = _distributions()["two_symbols"]
    s = port.compress(data, 1)
    pos, sfb, f2d, b2d = port.parse_tables_o1(s)
    pos2, none, f2d2, b2d2 = port.parse_tables_o1(s, want_sfb=False)
    assert none is None and sfb.shape == (256, 4096)
    assert pos == pos2
    assert np.array_equal(f2d, f2d2) and np.array_equal(b2d, b2d2)
    assert port.parse_tables_o1(s[:20], want_sfb=False) is None
