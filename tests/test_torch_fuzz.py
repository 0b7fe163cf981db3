"""The decoders' robustness contract, held on the port (device="cpu") as
tests/test_fuzz.py holds it on the JAX package, and then against the JAX
package itself.

Arbitrary bytes must give a clean ``ValueError`` (or ``OverflowError``)
or bounded output: never a crash, a hang or another exception.

- Single-stream decoders: the reference's seeded corpus (random bytes,
  bit-flipped valid streams, truncations) through every codec; each
  mutated stream decodes to the same bytes as through the JAX package's
  decoder, or both raise.  These are host coders: they agree exactly.
- Batched decoders (``engine="device"``: the kernels' plain versions): a
  third of each batch's members corrupted.  Intact members decode to
  their blocks and to the JAX package's output; a corrupt member raises
  ``ValueError`` for the whole call (the intact members then decode
  alone) or decodes to bytes of its claimed size.  The batch cases leave
  each stream's size field as it is: the plain versions decode whatever
  the header claims, one step at a time, so a claim of a few MB would
  take minutes here.  Size claims are driven on the card, through the
  kernels, by ``chip_smoke.py``'s ``fuzz_paths`` phase.
- Where a corrupt member decodes otherwise than through the JAX
  package's batch entry, the port follows the JAX package's device
  function (its TPU kernel's semantics), not its CPU fallback: the three
  ``test_divergence_*`` cases pin each one, named in their docstrings.
"""

import numpy as np
import pytest

from htscodecs_tpu import native as ref_native
from htscodecs_tpu.models import arith as ref_arith
from htscodecs_tpu.models import batch as ref_batch
from htscodecs_tpu.models import fqz as ref_fqz
from htscodecs_tpu.models import rans4x8 as ref_r4x8
from htscodecs_tpu.models import rans4x16 as ref_r4x16
from htscodecs_tpu.models import tok3 as ref_tok3
from htscodecs_tpu.ops import arith_jax as ref_arith_jax
from htscodecs_tpu_torch import native as port_native
from htscodecs_tpu_torch.models import arith, batch, fqz, rans4x8, rans4x16, tok3
from htscodecs_tpu_torch.utils import testdata, varint

pytestmark = pytest.mark.skipif(
    not (ref_native.available() and port_native.available()),
    reason="native host kernels unavailable")

CPU = "cpu"


# ---------------------------------------------------------------------------
# single-stream decoders

def _mutations(blob: bytes, rng, n=30):
    """tests/test_fuzz.py's corpus."""
    yield b""
    for k in (1, 2, 7, 16):
        yield bytes(rng.integers(0, 256, k, dtype=np.uint8))
    for _ in range(n):
        m = bytearray(blob)
        for _ in range(int(rng.integers(1, 6))):
            if m:
                m[int(rng.integers(0, len(m)))] ^= 1 << int(rng.integers(0, 8))
        yield bytes(m)
    for _ in range(n // 2):
        cut = int(rng.integers(0, max(1, len(blob))))
        yield blob[:cut]
    for _ in range(n // 2):
        yield bytes(rng.integers(0, 256, int(rng.integers(1, 400)),
                                 dtype=np.uint8))


def _outcome(decode, blob):
    try:
        out = decode(blob)
    except (ValueError, OverflowError):
        return "raises"
    # bounded output only (a stream may claim any u32 size: the
    # contract caps at the claim)
    assert out is None or len(out) < 2**31
    return out


def _exercise(decode, ref_decode, blob, rng):
    for k, mut in enumerate(_mutations(blob, rng)):
        got = _outcome(decode, mut)
        assert got == _outcome(ref_decode, mut), (k, mut[:32].hex())


@pytest.fixture(scope="module")
def sample():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 24, 3000, dtype=np.uint8) + 33).astype(np.uint8)


@pytest.mark.parametrize("order", [0, 1, 8, 129, 193])
def test_fuzz_rans4x16(sample, order):
    rng = np.random.default_rng(1 + order)
    blob = rans4x16.compress(sample, order)
    assert blob == ref_r4x16.compress(sample, order)
    _exercise(rans4x16.uncompress, ref_r4x16.uncompress, blob, rng)


@pytest.mark.parametrize("order", [0, 1])
def test_fuzz_rans4x8(sample, order):
    rng = np.random.default_rng(2 + order)
    blob = rans4x8.compress(sample, order)
    _exercise(rans4x8.uncompress, ref_r4x8.uncompress, blob, rng)


@pytest.mark.parametrize("order", [0, 1, 9, 65, 128])
def test_fuzz_arith(sample, order):
    rng = np.random.default_rng(3 + order)
    blob = arith.compress(sample, order)
    _exercise(arith.uncompress, ref_arith.uncompress, blob, rng)


def test_fuzz_fqz(sample):
    rng = np.random.default_rng(4)
    lens = [100] * 30
    blob = fqz.compress(bytes(sample[:3000] % 40), lens, [0] * 30, strat=1)
    _exercise(fqz.decompress, ref_fqz.decompress, blob, rng)


def test_fuzz_tok3():
    rng = np.random.default_rng(5)
    names = b"".join(b"read%d:%d:%d\n" % (i, i * 7 % 100, i * 13 % 997)
                     for i in range(100))
    blob = tok3.encode_names(names, 5, False, device=CPU)
    assert blob == ref_tok3.encode_names(names, 5, False)
    _exercise(lambda b: tok3.decode_names(b, device=CPU),
              ref_tok3.decode_names, blob, rng)


# ---------------------------------------------------------------------------
# batched decoders

def _size_end(codec, s):
    """The end of a stream's order byte and size field: mutations start
    there, so that no member claims another size."""
    return 9 if codec == "r4x8" else varint.get_uint(s, 1, len(s))[1]


def _corrupt(codec, streams, rng):
    """A third of the members, each by bit flips anywhere past the size
    field, a byte stored in the 32 bytes after it (the tables and the
    arith max-symbol byte), or a cut."""
    bad, hit = list(streams), []
    for k in range(0, len(streams), 3):
        s = bytearray(streams[k])
        h = _size_end(codec, s)
        kind = k // 3 % 3
        if kind == 0:
            for _ in range(int(rng.integers(1, 4))):
                s[int(rng.integers(h, len(s)))] ^= 1 << int(rng.integers(0, 8))
        elif kind == 1:
            s[int(rng.integers(h, min(len(s), h + 32)))] = \
                int(rng.integers(0, 256))
        else:
            s = s[:int(rng.integers(h + 1, len(s)))]
        bad[k] = bytes(s)
        hit.append(k)
    return bad, hit


ENTRIES = {
    "r4x16": (batch.compress_blocks,
              lambda s: batch.uncompress_blocks(s, engine="device",
                                                device=CPU),
              lambda s: ref_batch.uncompress_blocks(s, engine="device")),
    "r4x8": (batch.r4x8_compress_blocks,
             lambda s: batch.r4x8_uncompress_blocks(s, engine="device",
                                                    device=CPU),
             lambda s: ref_batch.r4x8_uncompress_blocks(s, engine="device")),
    "arith": (batch.arith_compress_blocks,
              lambda s: batch.arith_uncompress_blocks(s, engine="device",
                                                      device=CPU),
              lambda s: ref_batch.arith_uncompress_blocks(s, engine="device")),
}


def _blocks(seed, B=9, N=600):
    """Quality-like blocks and pair-structured wide ones, all of one
    length, so that each batch is one device group."""
    q = testdata.synth_quality(B // 2, N, seed=seed)
    w = testdata.synth_wide(B - B // 2, N, 40, seed=seed + 1)
    return list(q) + list(w)


@pytest.mark.parametrize("codec,order", [
    ("r4x16", 0), ("r4x16", 1), ("r4x16", 9), ("r4x8", 0), ("r4x8", 1),
    ("arith", 0), ("arith", 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_batched_decode_of_corrupt_members(codec, order, seed):
    """Intact members equal their blocks and the JAX batch entry's
    output; a corrupt member raises ValueError for the whole call (the
    intact members then decode alone) or decodes to bytes.  A corrupt
    4x16 member equals the JAX batch entry's bytes too; arith members
    equal the JAX device function's (``test_divergence_arith_*``); 4x8
    members are pinned by ``test_divergence_r4x8_*``."""
    enc, dec, ref_dec = ENTRIES[codec]
    blocks = _blocks(10 * seed + order)
    streams = enc(blocks, order, engine="device", device=CPU)
    bad, hit = _corrupt(codec, streams, np.random.default_rng(seed))
    intact = [k for k in range(len(bad)) if k not in hit]
    try:
        out = dec(bad)
    except ValueError:
        out = None
    if out is None:
        alone = dec([bad[k] for k in intact])
        assert alone == [blocks[k].tobytes() for k in intact]
        assert alone == ref_dec([bad[k] for k in intact])
        return
    want = ref_dec(bad)
    for k in intact:
        assert out[k] == blocks[k].tobytes() == want[k], k
    for k in hit:
        assert len(out[k]) == len(blocks[k]), k
        if codec == "r4x16":
            assert out[k] == want[k], k
    if codec == "arith":
        _hold_to_the_device_function(bad, out, order)


def _hold_to_the_device_function(streams, out, order):
    """Every member of an arith batch equals the JAX package's device
    function ``arith_jax.dec_batch`` on the same payloads, its width cap
    (MAX_DENSE_M = 96, above which the JAX batch entry takes the host
    coder) lifted to the port's 256."""
    pay, ms, osz = [], [], None
    for s in streams:
        osz, pos = varint.get_uint(s, 1, len(s))
        pay.append(s[pos + 1:])
        ms.append(s[pos] or 256)
    keep = ref_arith_jax.MAX_DENSE_M
    ref_arith_jax.MAX_DENSE_M = 256
    try:
        want = ref_arith_jax.dec_batch(pay, [osz] * len(pay), ms, order)
    finally:
        ref_arith_jax.MAX_DENSE_M = keep
    for k, s in enumerate(out):
        assert s == want[k, :osz].tobytes(), k


def test_divergence_r4x8_corrupt_table_decodes_as_the_tpu_kernel():
    """A 4x8 order-1 member whose table byte 10 is set to 4 (was 35).
    The port decodes it as the JAX package's TPU kernel does,
    ``htscodecs_tpu.ops.rans8_vmem.dec_o1_batch`` (Pallas; its output in
    interpret mode on these inputs is pinned below, as running it here
    would add an interpret-mode case), not as the JAX batch entry's CPU
    path ``rans8_v2.dec_o1_batch`` (XLA), which differs from byte 33 on.
    The intact neighbour decodes exactly either way."""
    blocks = list(testdata.synth_quality(2, 64, seed=0))
    streams = batch.r4x8_compress_blocks(blocks, 1, engine="device",
                                         device=CPU)
    s = bytearray(streams[0])
    assert s[10] == 35
    s[10] = 4
    bad = [bytes(s), streams[1]]
    tpu_kernel = bytes.fromhex(
        "46464646464646464646383838383838383838383838383838383838383838"
        "380446464646464646464646464646464646464646464646464646464646"
        "464646")
    out = batch.r4x8_uncompress_blocks(bad, engine="device", device=CPU)
    assert out == [tpu_kernel, blocks[1].tobytes()]
    xla = ref_batch.r4x8_uncompress_blocks(bad, engine="device")
    assert xla[1] == out[1]
    assert xla[0][:33] == out[0][:33] and xla[0] != out[0]


def _arith_wide(order, cut=0, ms_byte=None):
    """Eight arith blocks of 200 bytes over 120 symbols (above the JAX
    device function's cap of 96), the first member cut or given another
    max-symbol byte."""
    blocks, _lens, _ms = testdata.arith_blocks(8, 200, 120, seed=4)
    blocks = list(blocks)
    streams = batch.arith_compress_blocks(blocks, order, engine="device",
                                          device=CPU)
    s = bytearray(streams[0])
    if cut:
        s = s[:-cut]
    if ms_byte is not None:
        pos = varint.get_uint(s, 1, len(s))[1]
        s[pos] = ms_byte
    return blocks, [bytes(s)] + streams[1:]


@pytest.mark.parametrize("order", [0, 1])
def test_divergence_arith_truncated_member(order):
    """An arith member cut 6 bytes short, in a batch of width 120.  The
    port decodes it as the JAX package's device function
    ``htscodecs_tpu.ops.arith_jax.dec_batch`` does (the arithmetic of
    its TPU kernels; reads past the end give 0) with its width cap
    lifted; the JAX batch entry refuses widths above 96 and takes the
    host coder, which stops at the end."""
    blocks, bad = _arith_wide(order, cut=6)
    out = batch.arith_uncompress_blocks(bad, engine="device", device=CPU)
    assert out[1:] == [b.tobytes() for b in blocks[1:]]
    _hold_to_the_device_function(bad, out, order)
    ref = ref_batch.arith_uncompress_blocks(bad, engine="device")
    assert ref[0] == ref_arith.uncompress(bad[0]) != out[0]
    assert ref[1:] == out[1:]


def test_divergence_arith_raised_max_symbol_byte():
    """An order-0 member whose max-symbol byte says 0x9f where the
    block's is 0x2b (four blocks of 200 bytes).  The wider model makes
    the decode run past the stream's end.  The port decodes it with the
    width the stream states, as ``htscodecs_tpu.ops.arith_jax.dec_batch``
    does with its width cap lifted (reads past the end give 0); the JAX
    batch entry sends the whole group to the host coder, which stops at
    the end, so its bytes differ."""
    blocks = list(testdata.arith_blocks(4, 200, 0x2b, seed=35)[0])
    streams = batch.arith_compress_blocks(blocks, 0, engine="device",
                                          device=CPU)
    s = bytearray(streams[0])
    pos = varint.get_uint(s, 1, len(s))[1]
    assert s[pos] == 0x2b
    s[pos] = 0x9f
    bad = [bytes(s)] + streams[1:]
    out = batch.arith_uncompress_blocks(bad, engine="device", device=CPU)
    assert out[1:] == [b.tobytes() for b in blocks[1:]]
    _hold_to_the_device_function(bad, out, 0)
    ref = ref_batch.arith_uncompress_blocks(bad, engine="device")
    assert ref[0] == ref_arith.uncompress(bad[0]) != out[0]
    assert ref[1:] == out[1:]


def _claim(codec, stream, osz):
    if codec == "r4x8":
        return stream[:5] + osz.to_bytes(4, "little") + stream[9:]
    head = bytearray(stream[:1])
    varint.put_uint(head, osz)
    return bytes(head) + stream[varint.get_uint(stream, 1, len(stream))[1]:]


@pytest.mark.parametrize("codec,order", [("r4x16", 0), ("r4x16", 1),
                                         ("r4x8", 0), ("r4x8", 1)])
def test_a_claim_of_2_31_bytes_is_refused(codec, order):
    """A member that claims 2**31 bytes or more is refused with
    ValueError, as both packages' host coders refuse it, instead of
    sizing a device group at 2 GiB a block; its intact neighbours still
    decode alone."""
    enc, dec, _ref = ENTRIES[codec]
    blocks = _blocks(5, B=4, N=256)
    streams = enc(blocks, order, engine="device", device=CPU)
    for osz in (2**31 - 1, 2**31, 2**32 - 1):
        bad = [_claim(codec, streams[0], osz)] + streams[1:]
        with pytest.raises(ValueError):
            (ref_r4x8 if codec == "r4x8" else ref_r4x16).uncompress(bad[0])
        with pytest.raises(ValueError):
            dec(bad)
    assert dec(streams[1:]) == [b.tobytes() for b in blocks[1:]]
