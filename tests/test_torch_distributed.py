"""The block-sharded codecs (htscodecs_tpu_torch.parallel.distributed) on
a mesh of two CPU devices and in a two-process gloo group: streams are
byte-identical to the JAX package's single-block coders, every block
round-trips, the hooks really carry the groups, an exception inside a
hook propagates, and the archive index linearises across processes."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from htscodecs_tpu import native as ref_native
from htscodecs_tpu.models import arith as ref_arith
from htscodecs_tpu.models import fqz as ref_fqz
from htscodecs_tpu.models import rans4x8 as ref_r4x8
from htscodecs_tpu.models import rans4x16 as ref_r4x16
from htscodecs_tpu.models import tok3 as ref_tok3
from htscodecs_tpu_torch.models import batch
from htscodecs_tpu_torch.parallel import distributed as dist

pytestmark = pytest.mark.skipif(not ref_native.available(),
                                reason="native kernels unavailable")

REPO = Path(__file__).resolve().parent.parent
MESH = ["cpu", "cpu"]


def _mixed_shift_blocks(B=40, N=4096):
    rng = np.random.default_rng(3)
    syms = np.array([35, 45, 56, 70], np.uint8)
    out = np.empty((B, N), np.uint8)
    for b in range(B):
        vals = rng.choice(4, size=N // 8, p=[.05, .1, .15, .7])
        lens = rng.geometric(0.25, size=N // 8).clip(1, 60)
        seq = np.repeat(vals, lens)[:N]
        if len(seq) < N:
            seq = np.pad(seq, (0, N - len(seq)), constant_values=3)
        out[b] = syms[seq]
    return out


@pytest.fixture
def hook_calls(monkeypatch):
    """Counts the groups each sharded hook produced (not None)."""
    calls = {"bodies": 0, "dec": 0, "enc8": 0, "dec8": 0}

    def wrap(name, key):
        make = getattr(dist, name)

        def factory(mesh):
            fn = make(mesh)

            def hook(*a):
                r = fn(*a)
                calls[key] += r is not None
                return r
            return hook
        monkeypatch.setattr(dist, name, factory)

    for name, key in (("sharded_bodies_fn", "bodies"),
                      ("sharded_dec_fn", "dec"),
                      ("sharded_enc8_fn", "enc8"),
                      ("sharded_dec8_fn", "dec8")):
        wrap(name, key)
    return calls


def test_sharded_encode_byte_exact_and_roundtrip():
    blocks = _mixed_shift_blocks()
    streams = dist.compress_blocks_o1(blocks, MESH)
    for b, s in enumerate(streams):
        assert s == ref_r4x16.compress(blocks[b], 1), b
    back = dist.uncompress_blocks_o1(streams, MESH)
    for b in range(len(blocks)):
        assert back[b] == blocks[b].tobytes(), b


def test_sharded_encode_uniform_alphabet():
    rng = np.random.default_rng(1)
    blocks = (rng.integers(0, 12, (24, 2048)) + 33).astype(np.uint8)
    streams = dist.compress_blocks_o1(blocks, MESH)
    for b, s in enumerate(streams):
        assert s == ref_r4x16.compress(blocks[b], 1), b
    back = dist.uncompress_blocks_o1(streams, MESH)
    for b in range(len(blocks)):
        assert back[b] == blocks[b].tobytes(), b


def test_sharded_encode_mixed_shifts_in_one_group():
    """Blocks 19 and 20 of this batch take 10- and 12-bit tables: one
    group, a shift per block, one block on each device."""
    from htscodecs_tpu_torch.utils import testdata
    blocks = testdata.synth_quality(21, 65536, seed=42)[19:]
    streams = dist.compress_blocks_o1(blocks, MESH)
    assert {s[4] >> 4 for s in streams} == {10, 12}
    for b, s in enumerate(streams):
        assert s == ref_r4x16.compress(blocks[b], 1), b
    back = dist.uncompress_blocks_o1(streams, MESH)
    assert back == [b.tobytes() for b in blocks]


def test_wide_alphabet_falls_back():
    rng = np.random.default_rng(2)
    blocks = rng.integers(0, 250, (10, 1024)).astype(np.uint8)
    streams = dist.compress_blocks_o1(blocks, MESH)
    for b, s in enumerate(streams):
        assert s == ref_r4x16.compress(blocks[b], 1), b
    assert dist.uncompress_blocks_o1(streams, MESH) == \
        [b.tobytes() for b in blocks]


def _ragged_blocks():
    """Mixed lengths, CRAM-slice-like: two length groups and strays."""
    rng = np.random.default_rng(9)
    return [rng.choice(np.array([33, 40, 52, 66], np.uint8), size=n,
                       p=[.5, .3, .15, .05])
            for n in (2048, 2048, 2048, 1536, 1536, 4096, 777)]


@pytest.mark.parametrize("order", [0, 1])
def test_sharded_ragged_plain(order, hook_calls):
    blocks = _ragged_blocks()
    streams = dist.compress_blocks(blocks, order, MESH, engine="device")
    for b, s in enumerate(streams):
        assert s == ref_r4x16.compress(blocks[b], order), (order, b)
    back = dist.uncompress_blocks(streams, mesh=MESH, engine="device")
    for b in range(len(blocks)):
        assert back[b] == blocks[b].tobytes(), (order, b)
    assert hook_calls["bodies"] == 4 and hook_calls["dec"] == 4


@pytest.mark.parametrize("order", [193, 65, 129, 0x08 | (4 << 8)])
def test_sharded_transform_flagged(order, hook_calls):
    rng = np.random.default_rng(11)
    blocks = []
    for n in (4096, 4096, 4096, 2048):
        vals = rng.choice(np.array([2, 3, 5, 9], np.uint8), size=n,
                          p=[.6, .25, .1, .05])
        blocks.append(np.repeat(vals, 2)[:n])
    streams = dist.compress_blocks(blocks, order, MESH, engine="device")
    for b, s in enumerate(streams):
        assert s == ref_r4x16.compress(blocks[b], order), (order, b)
    back = dist.uncompress_blocks(streams, mesh=MESH, engine="device")
    for b in range(len(blocks)):
        assert back[b] == blocks[b].tobytes(), (order, b)
    assert hook_calls["bodies"] >= 1


def test_archive_offsets_single_process():
    offs, total = dist.archive_offsets([5, 0, 17, 3])
    assert list(offs) == [0, 5, 5, 22]
    assert total == 25


@pytest.mark.parametrize("order", [0, 1])
def test_sharded_r4x8(order, hook_calls):
    rng = np.random.default_rng(17)
    blocks = (rng.integers(0, 9, (24, 1500)) ** 2 % 37 + 33).astype(np.uint8)
    streams = dist.r4x8_compress_blocks(list(blocks), order, MESH,
                                        engine="device")
    for b, s in enumerate(streams):
        assert s == ref_r4x8.compress(blocks[b], order), (order, b)
    back = dist.r4x8_uncompress_blocks(streams, MESH, engine="device")
    for b in range(len(blocks)):
        assert back[b] == blocks[b].tobytes(), (order, b)
    assert hook_calls["enc8"] == 1 and hook_calls["dec8"] == 1


def test_blockdp_adaptive_codecs():
    rng = np.random.default_rng(23)
    blocks = [(rng.integers(0, 6, n) + 40).astype(np.uint8)
              for n in (700, 500, 700)]
    for order in (0, 1, 65):
        st = dist.arith_compress_blocks(blocks, order, MESH)
        for b, s in enumerate(st):
            assert s == ref_arith.compress(blocks[b], order), (order, b)
        back = dist.arith_uncompress_blocks(st, mesh=MESH)
        for b in range(len(blocks)):
            assert back[b] == blocks[b].tobytes(), (order, b)

    jobs = []
    for k in range(3):
        lens = [50, 50, 60, 40][: 3 + k % 2]
        data = (rng.integers(0, 30, sum(lens)) + 5).astype(np.uint8)
        jobs.append((data.tobytes(), lens))
    st = dist.fqz_compress_blocks(jobs, MESH)
    for k, s in enumerate(st):
        assert s == ref_fqz.compress(jobs[k][0], jobs[k][1]), k
    back = dist.fqz_decompress_blocks(st)
    for k in range(len(jobs)):
        assert back[k] == jobs[k][0], k

    names = [b"".join(b"read%d.%d/%d\n" % (j, j * 7 % 13, 1 + (j & 1))
                      for j in range(40)) for _ in range(3)]
    st = dist.tok3_encode_blocks(names, level=5, mesh=MESH)
    for k, s in enumerate(st):
        assert s == ref_tok3.encode_names(names[k], 5), k
    back = dist.tok3_decode_blocks(st, MESH)
    for k in range(len(names)):
        assert back[k] == names[k].replace(b"\n", b"\x00"), k
    offs, total = dist.archive_offsets([len(s) for s in st])
    assert total == sum(len(s) for s in st)


# ---------------------------------------------------------------------
# the hooks of the batch layer

def _boom(*_a):
    raise RuntimeError("boom from the hook")


def _group(n=1024, B=20):
    rng = np.random.default_rng(5)
    return list((rng.integers(0, 6, (B, n)) + 40).astype(np.uint8))


@pytest.mark.parametrize("entry", ["compress", "compress_transform",
                                   "uncompress", "r4x8_compress",
                                   "r4x8_uncompress"])
def test_an_exception_in_a_hook_propagates(entry):
    blocks = _group()
    kw = {"engine": "device", "device": "cpu"}
    with pytest.raises(RuntimeError, match="boom from the hook"):
        if entry == "compress":
            batch.compress_blocks(blocks, 1, bodies_fn=_boom, **kw)
        elif entry == "compress_transform":
            batch.compress_blocks(blocks, 0x08 | (4 << 8), bodies_fn=_boom,
                                  **kw)
        elif entry == "uncompress":
            streams = batch.compress_blocks(blocks, 1, **kw)
            batch.uncompress_blocks(streams, dec_fn=_boom, **kw)
        elif entry == "r4x8_compress":
            batch.r4x8_compress_blocks(blocks, 1, enc_fn=_boom, **kw)
        else:
            streams = batch.r4x8_compress_blocks(blocks, 1, **kw)
            batch.r4x8_uncompress_blocks(streams, dec_fn=_boom, **kw)


def test_a_hook_that_returns_none_leaves_the_usual_route():
    blocks = _group()
    kw = {"engine": "device", "device": "cpu"}
    none = lambda *a: None  # noqa: E731
    s16 = batch.compress_blocks(blocks, 1, bodies_fn=none, **kw)
    assert s16 == [ref_r4x16.compress(b, 1) for b in blocks]
    assert batch.uncompress_blocks(s16, dec_fn=none, **kw) == \
        [b.tobytes() for b in blocks]
    s8 = batch.r4x8_compress_blocks(blocks, 0, enc_fn=none, **kw)
    assert s8 == [ref_r4x8.compress(b, 0) for b in blocks]
    assert batch.r4x8_uncompress_blocks(s8, dec_fn=none, **kw) == \
        [b.tobytes() for b in blocks]


def test_init_distributed_without_arguments_is_a_noop(monkeypatch):
    for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    assert dist.init_distributed() is False


def test_default_mesh_without_a_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default mesh works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.compress_blocks(_group(), 1)


# ---------------------------------------------------------------------
# two processes in one gloo group

WORKER = textwrap.dedent("""
    import sys
    rank = int(sys.argv[1]); rdv = sys.argv[2]
    sys.path.insert(0, "@REPO@")
    import numpy as np
    from htscodecs_tpu_torch.parallel import distributed as dist
    from htscodecs_tpu_torch.models import rans4x16
    assert dist.init_distributed(f"file://{rdv}", 2, rank)
    mesh = ["cpu", "cpu"]
    rng = np.random.default_rng(100 + rank)
    blocks = (rng.integers(0, 10, (16, 1024)) + 33).astype(np.uint8)
    streams = dist.compress_blocks_o1(blocks, mesh)
    assert all(streams[b] == rans4x16.compress(blocks[b], 1)
               for b in range(len(blocks)))
    offs, total = dist.archive_offsets([len(s) for s in streams])
    back = dist.uncompress_blocks_o1(streams, mesh)
    assert all(back[b] == blocks[b].tobytes() for b in range(len(blocks)))
    # ragged and transform-flagged: the groups differ from rank to rank
    ragged = [(rng.integers(0, 6, n) * 2 + 33).astype(np.uint8)
              for n in (768, 768, 512 + 128 * rank, 1024)]
    for order in (1, 193):
        rs = dist.compress_blocks(ragged, order, mesh, engine="device")
        assert all(rs[b] == rans4x16.compress(ragged[b], order)
                   for b in range(len(ragged))), order
        rb = dist.uncompress_blocks(rs, mesh=mesh, engine="device")
        assert all(rb[b] == ragged[b].tobytes()
                   for b in range(len(ragged))), order
    print("RESULT", rank, int(offs[0]), total, sum(map(len, streams)),
          flush=True)
""").replace("@REPO@", str(REPO))


def test_two_process_gloo_group(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    rdv = tmp_path / "rendezvous"
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(rdv)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i}:\n{out[-2000:]}"
    res = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, rank, off0, total, mine = line.split()
                res[int(rank)] = (int(off0), int(total), int(mine))
    assert set(res) == {0, 1}
    # rank 1's first block starts exactly where rank 0's bytes end
    assert res[0][0] == 0
    assert res[1][0] == res[0][2]
    assert res[0][1] == res[1][1] == res[0][2] + res[1][2]


def test_fqz_decompress_blocks_takes_the_jax_mesh_and_engine_keywords():
    """``mesh=`` and ``engine=`` are part of the JAX signature; the
    decode is host-only, so both are accepted and ignored."""
    jobs = [(np.arange(120, dtype=np.uint8) % 23 + 5, [60, 60])]
    st = dist.fqz_compress_blocks(jobs, MESH, engine="host")
    assert st == [ref_fqz.compress(jobs[0][0], jobs[0][1])]
    for kw in ({"mesh": None, "engine": "auto"},
               {"mesh": MESH, "engine": "device"}):
        assert dist.fqz_decompress_blocks(st, **kw) == [jobs[0][0].tobytes()]
