"""Block data parallelism over several devices and processes.

Counterpart of ``htscodecs_tpu/parallel/distributed.py``.  The codec
has no cross-block dataflow, so scale-out is block-level data
parallelism.  Within a process, every same-shape group of the batch
layer splits its rows over a list of devices (the "mesh"): each part
runs on its device's current stream, all parts are queued before any
is read back, and the results are joined in row order.  Across
processes (a ``torch.distributed`` group, one rank per process) each
rank codes its own blocks; compressed bytes never move, and the only
cross-process traffic is host integers: the all-gather of compressed
lengths in ``archive_offsets``.

The JAX package shards over a mesh that may span hosts, so its
decode gathers the table and word widths of every process
(``_allgather_max``) to give each shard one shape.  Here a mesh is
always local, and each part is coded at its own widths (the streams do
not depend on them), so nothing else crosses processes.

Entry points:

- ``init_distributed``      a gloo process group (the torchrun
                            variables or explicit arguments)
- ``block_mesh`` / ``local_mesh``
                            this process's CUDA devices (rank r of a
                            group takes ``cuda:(r % device_count())``)
- ``compress_blocks`` / ``uncompress_blocks``
                            rANS 4x16 of ragged, transform-flagged
                            batches: ``models.batch`` peels and groups,
                            the ``bodies_fn`` / ``dec_fn`` hooks split
                            each group over the mesh
- ``compress_blocks_o1`` / ``uncompress_blocks_o1``
                            order 1 of equal-length blocks (a per-block
                            shift; the decode groups nothing)
- ``r4x8_compress_blocks`` / ``r4x8_uncompress_blocks``
                            rANS 4x8 through the ``enc_fn`` / ``dec_fn``
                            hooks
- ``arith_*`` / ``fqz_*`` / ``tok3_*``
                            the adaptive codecs, whose blocks are their
                            scaling axis: each process codes its share
                            on the mesh's first device
- ``archive_offsets``       global byte offsets of ragged local blocks

No hook catches an exception: a failed launch raises out of the entry.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as tdist

from .. import native
from ..models import batch as batchmod
from ..models import rans4x16
from ..ops import convert, rans8_v2, rans_v2, tables_v2
from ..utils import varint

_TORCHRUN_VARS = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def init_distributed(init_method=None, world_size=None, rank=None,
                     **kw) -> bool:
    """Build a gloo process group for a multi-process run: from the
    arguments (e.g. ``init_method="tcp://localhost:29500"`` or
    ``"file:///tmp/rendezvous"``), or from the torchrun variables
    (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``).  A no-op returning False
    when neither is given; True once the group is up.  gloo carries the
    host integers the codecs exchange, whether the ranks share a card
    or not."""
    if (init_method is None and world_size is None and rank is None
            and not all(v in os.environ for v in _TORCHRUN_VARS)):
        return False
    tdist.init_process_group("gloo", init_method=init_method or "env://",
                             world_size=-1 if world_size is None
                             else world_size,
                             rank=-1 if rank is None else rank, **kw)
    return True


def _process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def local_mesh() -> list[torch.device]:
    """This process's CUDA devices: all of them in a single process; in
    a process group, rank r takes ``cuda:(r % device_count())``.
    Without a card this raises."""
    rans_v2.check_device("cuda")
    n = torch.cuda.device_count()
    if _process_count() == 1:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", tdist.get_rank() % n)]


def block_mesh(devices=None) -> list[torch.device]:
    """The devices that a group's rows split over: the given ones
    (``torch.device``s or names such as ``"cpu"``), else
    ``local_mesh()``."""
    if devices is None:
        return local_mesh()
    return [torch.device(d) for d in devices]


def _parts(B: int, mesh) -> list[tuple]:
    """(device, start, stop) of each non-empty part of B rows split over
    the mesh in row order (sizes differ by at most one)."""
    cuts = np.linspace(0, B, len(mesh) + 1).round().astype(int)
    return [(d, int(a), int(b)) for d, a, b in zip(mesh, cuts[:-1], cuts[1:])
            if b > a]


def _pad_cols(arrs: list[np.ndarray]) -> np.ndarray:
    """Row blocks of differing widths -> one zero-padded array."""
    W = max(a.shape[1] for a in arrs)
    return np.concatenate([np.pad(a, ((0, 0), (0, W - a.shape[1])))
                           for a in arrs])


# ---------------------------------------------------------------------------
# rANS 4x16 encode

def _sharded_bodies_o1(batch: np.ndarray, mesh) -> list[bytes] | None:
    """Order-1 entropy bodies (header + payload, no wrapper framing) of a
    group whose rows split over the mesh: each part's device table build
    and encode are queued before any part's headers are serialised.
    Blocks whose banded shift decision really flips rebuild on the host,
    so streams stay byte-exact.  None -> the caller's usual route (an
    alphabet wider than 96 in some part, tiny or giant blocks, no native
    library)."""
    B, N = batch.shape
    if N < 32 or N >= (1 << 23) or not native.available():
        return None
    pending = []
    for dev, a, b in _parts(B, mesh):
        p = batchmod._o1_devtables_launch(batch[a:b], dev)
        if p is None:
            return None
        pending.append((a, b, p))
    out: list[bytes] = []
    for a, b, p in pending:
        bodies = batchmod._o1_devtables_finish(batch[a:b], p)
        if bodies is None:
            return None
        out += bodies
    return out


def _sharded_bodies_o0(batch: np.ndarray, mesh) -> list[bytes] | None:
    """Order-0 entropy bodies of a group split over the mesh; None ->
    the caller's usual route."""
    B, N = batch.shape
    if N < 1 or N >= (1 << 23) or not native.available():
        return None
    out: list[bytes] = []
    for dev, a, b in _parts(B, mesh):
        bodies = batchmod._bodies_o0_devtables(batch[a:b], dev)
        if bodies is None:
            return None
        out += bodies
    return out


def sharded_bodies_fn(mesh):
    """Entropy-body producer for ``models.batch.compress_blocks``'
    ``bodies_fn`` hook: every same-shape group splits over the mesh."""
    def fn(batch: np.ndarray, order01: int):
        return (_sharded_bodies_o1(batch, mesh) if order01
                else _sharded_bodies_o0(batch, mesh))
    return fn


def compress_blocks(blocks, order: int = 1, mesh=None,
                    engine: str = "auto") -> list[bytes]:
    """rANS 4x16 compression of this process's blocks over the mesh:
    ragged lengths and any order bit-field (STRIPE / PACK / RLE / CAT /
    NOSZ).  ``models.batch`` groups and peels; every same-shape entropy
    group (plain blocks, stripe lanes and transform candidates) splits
    over the mesh.  Groups the hook refuses go to the batch layer's
    route on the mesh's first device.  Streams are byte-identical to
    ``rans4x16.compress``."""
    mesh = block_mesh(mesh)
    return batchmod.compress_blocks(blocks, order, engine=engine,
                                    device=mesh[0],
                                    bodies_fn=sharded_bodies_fn(mesh))


def compress_blocks_o1(blocks: np.ndarray, mesh=None) -> list[bytes]:
    """Order-1 compression of this process's equal-length blocks (B, N)
    over the mesh, device tables included.  Streams are byte-identical
    to ``rans4x16.compress(b, 1)``; alphabets wider than 96 code on the
    host."""
    mesh = block_mesh(mesh)
    blocks = np.ascontiguousarray(blocks, np.uint8)
    B, N = blocks.shape
    bodies = _sharded_bodies_o1(blocks, mesh)
    if bodies is None:
        return [rans4x16.compress(b, 1) for b in blocks]
    return [batchmod._frame(1, N, body, blocks[b])
            for b, body in enumerate(bodies)]


# ---------------------------------------------------------------------------
# rANS 4x16 decode

def _sharded_dec_group(order: int, osz: int, states, words, alpha, packed,
                       shift, mesh) -> np.ndarray:
    """Decode one same-shape entropy group split over the mesh (the
    dense per-block arrays ``models.batch`` assembled); every part is
    queued before any is copied back.  Returns (B, osz) uint8."""
    outs = [rans_v2._dec_tensor(states[a:b], words[a:b], osz, alpha[a:b],
                                packed[a:b], shift if np.isscalar(shift)
                                else shift[a:b], order, dev)
            for dev, a, b in _parts(len(states), mesh)]
    return np.concatenate([o.cpu().numpy() for o in outs])


def sharded_dec_fn(mesh):
    """Decode-group engine for ``models.batch.uncompress_blocks``'
    ``dec_fn`` hook."""
    def fn(order, osz, states, words, alpha, packed, shift):
        return _sharded_dec_group(order, osz, states, words, alpha, packed,
                                  shift, mesh)
    return fn


def uncompress_blocks(streams, out_sizes=None, mesh=None,
                      engine: str = "auto") -> list[bytes]:
    """rANS 4x16 decompression over the mesh: mixed sizes, PACK / RLE /
    CAT / NOSZ wrappers and STRIPE containers; every same-shape entropy
    group (every stripe lane's included) splits over the mesh."""
    mesh = block_mesh(mesh)
    return batchmod.uncompress_blocks(streams, out_sizes, engine=engine,
                                      device=mesh[0],
                                      dec_fn=sharded_dec_fn(mesh))


def uncompress_blocks_o1(streams, mesh=None) -> list[bytes]:
    """Decode of equal-output-size plain order-1 streams (what
    ``compress_blocks_o1`` makes) over the mesh; anything else goes to
    the host decoder."""
    mesh = block_mesh(mesh)
    streams = [bytes(s) for s in streams]

    def host_all():
        return [rans4x16.uncompress(s) for s in streams]

    parsed = []
    N = None
    for s in streams:
        if len(s) < 2 or s[0] != 1:
            return host_all()
        osz, pos = varint.get_uint(s, 1, len(s))
        if N is None:
            N = osz
        elif osz != N:
            return host_all()
        r = native.parse_tables_o1_dense(s[pos:]) if native.available() \
            else None
        if r is None:
            return host_all()
        off, al, pk, sh = r
        payload = s[pos + off:]
        if len(payload) < 16:
            return host_all()
        parsed.append((al, pk, sh, payload))
    if N is None or N < 4:
        return host_all()

    B = len(parsed)
    amax = max(len(p[0]) for p in parsed)
    if amax > tables_v2.MAX_DENSE_A:
        return host_all()
    W = max(max((len(p[3]) - 16) // 2 for p in parsed), 1)
    alpha, packed, _A = rans_v2.densify_builds((p[0], p[1]) for p in parsed)
    states = np.zeros((B, 4), np.uint32)
    words = np.zeros((B, W), "<u2")
    shift = np.array([p[2] for p in parsed], np.int32)
    for k, (_al, _pk, _sh, payload) in enumerate(parsed):
        states[k] = np.frombuffer(payload[:16], "<u4")
        w = np.frombuffer(payload[16:16 + 2 * ((len(payload) - 16) // 2)],
                          "<u2")
        words[k, :len(w)] = w
    out = _sharded_dec_group(1, N, states, words, alpha, packed, shift, mesh)
    return [out[k].tobytes() for k in range(B)]


# ---------------------------------------------------------------------------
# rANS 4x8 (CRAM 3.0) through the enc_fn / dec_fn hooks
# (reference dispatch: rANS_static.c:927-943)

def sharded_enc8_fn(mesh):
    """Payload-scan engine for ``models.batch.r4x8_compress_blocks``'
    ``enc_fn`` hook: the group's rows split over the mesh."""
    def fn(batch: np.ndarray, alpha, packed, order01: int):
        parts = _parts(len(batch), mesh)
        outs = [rans8_v2._enc8_tensors(batch[a:b], alpha[a:b], packed[a:b],
                                       order01, dev)
                for dev, a, b in parts]
        res = [convert.streams8_to_reference(*o) for o in outs]
        return (np.concatenate([r[0] for r in res]),
                _pad_cols([r[1] for r in res]),
                np.concatenate([r[2] for r in res]))
    return fn


def sharded_dec8_fn(mesh):
    """Decode-group engine for ``models.batch.r4x8_uncompress_blocks``'
    ``dec_fn`` hook."""
    def fn(order01, osz, states, stream, alpha, packed):
        outs = [rans8_v2._dec8_tensor(states[a:b], stream[a:b], osz,
                                      alpha[a:b], packed[a:b], order01, dev)
                for dev, a, b in _parts(len(states), mesh)]
        return np.concatenate([o.cpu().numpy() for o in outs])
    return fn


def r4x8_compress_blocks(blocks, order: int = 1, mesh=None,
                         engine: str = "auto") -> list[bytes]:
    """rANS 4x8 compression over the mesh: ``models.batch``'s grouping
    and host table build, each group's payload scans split over the
    mesh.  Streams byte-identical to ``rans4x8.compress``."""
    mesh = block_mesh(mesh)
    return batchmod.r4x8_compress_blocks(blocks, order, engine=engine,
                                         device=mesh[0],
                                         enc_fn=sharded_enc8_fn(mesh))


def r4x8_uncompress_blocks(streams, mesh=None,
                           engine: str = "auto") -> list[bytes]:
    """rANS 4x8 decompression over the mesh."""
    mesh = block_mesh(mesh)
    return batchmod.r4x8_uncompress_blocks(streams, engine=engine,
                                           device=mesh[0],
                                           dec_fn=sharded_dec8_fn(mesh))


# ---------------------------------------------------------------------------
# adaptive codecs (arith / fqz / tok3): a serial chain per block, so the
# blocks are the scaling axis.  Each process codes its share with the
# batch layer on the mesh's first device; across processes only
# archive_offsets' lengths move.  Reference entry points:
# arith_dynamic.c:760-862, fqzcomp_qual.c:1492-1502,
# tokenise_name3.c:1334-1538.

def arith_compress_blocks(blocks, order: int = 0, mesh=None,
                          engine: str = "auto") -> list[bytes]:
    """arith_dynamic compression of this process's blocks.  Streams
    byte-identical to ``arith.compress``."""
    mesh = block_mesh(mesh)
    return batchmod.arith_compress_blocks(blocks, order, engine=engine,
                                          device=mesh[0])


def arith_uncompress_blocks(streams, out_sizes=None, mesh=None,
                            engine: str = "auto") -> list[bytes]:
    mesh = block_mesh(mesh)
    return batchmod.arith_uncompress_blocks(streams, out_sizes,
                                            engine=engine, device=mesh[0])


def fqz_compress_blocks(jobs, mesh=None, engine: str = "auto") -> list[bytes]:
    """fqzcomp_qual compression of this process's slices (each job =
    (data, lens[, flags[, strat]]))."""
    mesh = block_mesh(mesh)
    return batchmod.fqz_compress_blocks(jobs, engine=engine, device=mesh[0])


def fqz_decompress_blocks(streams, mesh=None,
                          engine: str = "auto") -> list[bytes]:
    """fqzcomp_qual decompression on the host (as
    ``models.batch.fqz_decompress_blocks``: no batched decode exists).
    ``mesh`` and ``engine`` are accepted for the JAX signature's sake
    and ignored, as there."""
    return batchmod.fqz_decompress_blocks(streams, engine=engine)


def tok3_encode_blocks(blocks, level: int = 9, use_arith: bool = False,
                       mesh=None) -> list[bytes]:
    """Name-tokeniser compression of this process's name blocks (each
    block = newline-terminated names)."""
    from ..models import tok3
    dev = block_mesh(mesh)[0]
    return batchmod._pmap(
        lambda b: tok3.encode_names(b, level, use_arith, device=dev),
        list(blocks))


def tok3_decode_blocks(blocks, mesh=None) -> list[bytes]:
    from ..models import tok3
    dev = block_mesh(mesh)[0]
    return batchmod._pmap(lambda s: tok3.decode_names(s, device=dev),
                          list(blocks))


# ---------------------------------------------------------------------------
# ragged container index

def archive_offsets(local_lengths) -> tuple[np.ndarray, int]:
    """Global byte offsets of this process's compressed blocks.

    Every process of the group calls this with its per-block stream
    lengths (equal counts across processes: pad with zero-length
    entries); the lengths are all-gathered (gloo, host integers) and
    each process computes its blocks' offsets in the archive that
    concatenates rank 0's blocks, then rank 1's, and so on.  Returns
    (offsets (L,), total bytes)."""
    ll = np.asarray(local_lengths, np.int64)
    if _process_count() == 1:
        return np.cumsum(ll) - ll, int(ll.sum())
    mine = torch.from_numpy(ll)
    allv = [torch.empty_like(mine) for _ in range(_process_count())]
    tdist.all_gather(allv, mine)
    flat = torch.cat(allv).numpy()
    offs = (np.cumsum(flat) - flat).reshape(len(allv), -1)
    return offs[tdist.get_rank()], int(flat.sum())
