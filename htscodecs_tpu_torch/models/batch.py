"""Batched block codec API (rANS 4x16, rANS 4x8 and arith_dynamic,
order 0 and 1; the fqzcomp_qual encode).

Counterpart of ``htscodecs_tpu/models/batch.py``.
Compresses/decompresses many independent CRAM blocks at once: the
entropy payload work of a large enough group of equal-length blocks
goes to the batched CUDA engine (ops/rans_vmem.py: its one encoder reads
the packed rows on both table routes, its decoder the base rows; dense
alphabets A <= 96), everything else to
the native host coder.  Streams are byte-identical to
``rans4x16.compress`` / the C reference in every path.

Batching rules: blocks group by (length, order[, table precision]) —
the kernels are launched per shape.  Encode tables of a group of at
least ``TABLES_DEVICE_MIN`` blocks of at least 32 bytes are built on
the device (``ops/tables_v2.py``, as in the JAX package, with a
threshold measured on the card), those of smaller groups on the host
(native C over a thread pool);
``TABLE_ROUTES`` counts the groups that took each route.  Decode tables
are parsed on the host and shipped to the device as dense per-block
tables.

``r4x8_compress_blocks`` / ``r4x8_uncompress_blocks`` are the same
layer for the CRAM 3.0 codec (rANS 4x8): tables from the native dense
table build, payload scans in ``ops/rans8_vmem.py``, the pure-Python
``rans4x8`` coder for everything the batched engine does not take.

``arith_compress_blocks`` / ``arith_uncompress_blocks`` are the layer
for the adaptive arith_dynamic codec: groups of equal-length plain
order-0/1 blocks go to ``ops/arith_vmem.py`` whatever their alphabet,
anything else (RLE, PACK, STRIPE, EXT, CAT flags; blocks under 8 bytes)
to the host codec ``models/arith.py``.  ``fqz_compress_blocks`` replays
each job's models on the host and runs the range coders of all jobs in
one kernel (``fqz.compress_batch_device``); ``fqz_decompress_blocks``
is the host decoder over the thread pool.  In the JAX package
``engine="auto"`` means the host for these two codecs; here, as for the
rANS entries, it means the card for every large enough group.

Transform-flagged rANS 4x16 orders (PACK / RLE / CAT / NOSZ, STRIPE
containers) are peeled on the host, and their entropy payloads, every
stripe lane's included, join the same batched device groups as plain
blocks: on encode every candidate payload of a stripe lane's method
search is deferred (``_peel_encode``, ``_encode_entropy_jobs``), on
decode every lane and body (``_peel_wrapper``, ``_peel_stripe``,
``_decode_entropy_jobs``).  A finisher that cannot complete a block
sends it to the host coder.

Every entry point but the host-only ``fqz_decompress_blocks`` takes
``device`` and defaults to ``"cuda"``.  With no
card that default raises; ``device="cpu"`` runs the engine's plain
PyTorch versions (what the CPU tests do).  Nothing falls back from a
failed kernel to the CPU.

The rANS entries take the JAX package's engine hooks, through which the
block-sharded layer (``parallel/distributed.py``) runs every
same-shape group over several devices: ``compress_blocks(bodies_fn=)``,
``uncompress_blocks(dec_fn=)``, ``r4x8_compress_blocks(enc_fn=)`` and
``r4x8_uncompress_blocks(dec_fn=)``.  A hook is called with the JAX
hook's arguments; None from it means "take the usual route", and an
exception inside it propagates.
"""

from __future__ import annotations

import os
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import arith, fqz, rans4x8, rans4x16
from .. import native
from ..ops import (arith_vmem, convert, pack, rans8_v2, rans_v2, rans_vmem,
                   rle, tables_v2)
from ..utils import varint

# Below this many blocks in a shape group, the host path wins (device
# dispatch latency + staging dominate tiny batches).
DEVICE_MIN_GROUP = 16
# "auto" also requires this many payload bytes in a group before the
# device path engages (export HTSCODECS_TORCH_DEVICE_MIN_BYTES to
# retune).
DEVICE_MIN_BYTES = int(os.environ.get(
    "HTSCODECS_TORCH_DEVICE_MIN_BYTES", 4 << 20))

# Minimum group size for the on-device table builders: below it the
# host C builder over the thread pool builds the tables.  Measured on
# an H100 with 64 KiB blocks (chip_smoke.py's table-route sweep), the
# device route's compress wall wins at both orders from 64 blocks up
# and loses at 4 (order 1 also at 16); 64 such blocks are also the
# 4 MiB that "auto" needs to reach the card at all.  (The JAX package
# uses 512.)
TABLES_DEVICE_MIN = 64
# rANS 4x16 encode groups by table route ("device": ops/tables_v2,
# "host": native C), counted as rans_vmem.LAUNCHES counts launches, so
# that a run can show which route a batch took
TABLE_ROUTES = {"device": 0, "host": 0}

# rANS 4x16 entropy jobs of transform-flagged encodes and of all decodes
# by route ("device": a batched group, "host": the native coder one job
# at a time), counted as TABLE_ROUTES counts groups
ENTROPY_JOBS = {"encode": {"device": 0, "host": 0},
                "decode": {"device": 0, "host": 0}}

# Host table construction is native C via ctypes (GIL released), so a
# thread pool scales it across cores.
_POOL = ThreadPoolExecutor(max_workers=min(16, (os.cpu_count() or 4)))


def _pmap(fn, items):
    if len(items) <= 2:
        return [fn(x) for x in items]
    return list(_POOL.map(fn, items))


def _as_u8(b) -> np.ndarray:
    if isinstance(b, np.ndarray):
        return b.astype(np.uint8, copy=False)
    return np.frombuffer(bytes(b), dtype=np.uint8)


def _small_group(count: int, nbytes: int, engine: str) -> bool:
    """True when "auto" keeps a shape group on the host."""
    return engine != "device" and (count < DEVICE_MIN_GROUP
                                   or count * nbytes < DEVICE_MIN_BYTES)


def compress_blocks(blocks, order: int, engine: str = "auto",
                    device="cuda", bodies_fn=None) -> list[bytes]:
    """Compress a sequence of blocks with the rANS 4x16 codec.

    Any reference order bit-field is accepted: plain 0/1 batches
    directly; transform-flagged orders (PACK/RLE/NOSZ, STRIPE
    containers) peel their transforms on the host and defer every
    entropy payload, every STRIPE lane's method-search candidate
    included (reference rANS_static4x16pr.c:1190-1213), into the same
    batched device groups.  Streams are byte-identical to
    ``rans4x16.compress`` in every path.

    engine: "auto" | "device" | "host".
    bodies_fn: optional entropy-body producer ``(batch (B,N) u8,
    order01) -> list[bytes] | None``, called for every group that would
    reach the device engine (plain blocks, stripe lanes and transform
    candidates alike); None from it sends the group the usual way.
    """
    dev = rans_v2.check_device(device)
    arrs = [_as_u8(b) for b in blocks]
    out: list[bytes | None] = [None] * len(arrs)

    plain_order = order in (0, 1)
    if not plain_order and engine != "host":
        return _compress_blocks_transform(arrs, order, engine, dev,
                                          bodies_fn)
    groups: dict[int, list[int]] = defaultdict(list)
    for i, a in enumerate(arrs):
        if plain_order and engine != "host" and len(a) >= 32:
            groups[len(a)].append(i)
        else:
            out[i] = rans4x16.compress(a, order)

    for n, idxs in groups.items():
        if _small_group(len(idxs), n, engine):
            for i in idxs:
                out[i] = rans4x16.compress(arrs[i], order)
            continue
        batch = np.stack([arrs[i] for i in idxs])
        bodies = bodies_fn(batch, order) if bodies_fn is not None else None
        if bodies is None:
            bodies = (_bodies_o1(batch, dev) if order == 1
                      else _bodies_o0(batch, dev))
        for k, i in enumerate(idxs):
            out[i] = _frame(order, n, bodies[k], batch[k])

    return out  # type: ignore[return-value]


# ---------------------------------------------------------------------
# transform-flagged encode: peel on the host, batch the entropy payloads

def _defer_entropy(jobs: list, data: np.ndarray, order01: int) -> int:
    jid = len(jobs)
    jobs.append((data, order01))
    return jid


def _finish(cand, res):
    return cand[1] if cand[0] == "done" else cand[1](res)


def _peel_encode(data: np.ndarray, order: int, jobs: list):
    """Mirror of rans4x16.compress with the entropy stages deferred.

    Returns ("done", bytes) or ("fin", callable(res) -> bytes | None)
    where res maps job ids to entropy body bytes (None -> the caller
    falls back to the host encoder for the whole block)."""
    in_size = len(data)
    if in_size <= 20:
        order &= ~rans4x16.X_STRIPE

    if order & rans4x16.X_STRIPE:
        N = order >> 8
        if N == 0:
            N = 4
        if N > 255:
            raise ValueError("stripe N too large")
        head = bytearray()
        head.append(order & ~rans4x16.X_NOSZ & 0xFF)
        varint.put_uint(head, in_size)
        head.append(N)
        lane_cands = []
        for j in range(N):
            lane = data[j::N]
            methods = [m for m in (1, 64, 128, 0) if (order & m) == m]
            lane_cands.append(
                [_peel_encode(lane, m | rans4x16.X_NOSZ, jobs)
                 for m in methods])

        def fin(res, head=bytes(head), lane_cands=lane_cands):
            streams = []
            for cands in lane_cands:
                best = None
                for c in cands:
                    s = _finish(c, res)
                    if s is None:
                        return None
                    if best is None or len(s) < len(best):
                        best = s
                streams.append(best)
            out = bytearray(head)
            for s in streams:
                varint.put_uint(out, len(s))
            for s in streams:
                out += s
            return bytes(out)

        return ("fin", fin)

    if order & rans4x16.X_CAT:
        out = bytearray([rans4x16.X_CAT])
        varint.put_uint(out, in_size)
        return ("done", bytes(out) + data.tobytes())

    do_pack = order & rans4x16.X_PACK
    do_rle = order & rans4x16.X_RLE
    no_size = order & rans4x16.X_NOSZ

    head = bytearray()
    head.append(order & 0xFF)
    if not no_size:
        varint.put_uint(head, in_size)
    order &= 0xF

    if do_pack and in_size:
        packed, pmeta, _nsym = pack.pack(data)
        if len(pmeta) == 1 and pmeta[0] > 16:
            head[0] &= ~rans4x16.X_PACK & 0xFF
        else:
            data = packed
            in_size = len(packed)
            head += pmeta
            varint.put_uint(head, in_size)
    elif do_pack:
        head[0] &= ~rans4x16.X_PACK & 0xFF

    rle_meta_jid = None
    rmeta = rle_len = None
    if do_rle and in_size:
        lits, runs, rle_syms = rle.encode(data)
        rmeta = bytes([len(rle_syms) & 0xFF]) + bytes(rle_syms.tolist()) + runs
        rle_len = len(lits)
        if rle_len + len(rmeta) >= 0.99 * in_size:
            head[0] &= ~rans4x16.X_RLE & 0xFF
        else:
            rle_meta_jid = _defer_entropy(
                jobs, np.frombuffer(rmeta, dtype=np.uint8), 0)
            data = lits
            in_size = rle_len
    elif do_rle:
        head[0] &= ~rans4x16.X_RLE & 0xFF

    if order and in_size < 8:
        head[0] &= ~1
        order &= ~1

    # the body is order-1 ONLY for order == 1: low-nibble values 2..15
    # code order-0 (reference rANS_static4x16pr.c:1327)
    jid = _defer_entropy(jobs, data, 1 if order == 1 else 0)

    def fin(res, head=bytes(head), data=data, in_size=in_size,
            jid=jid, rle_meta_jid=rle_meta_jid, rmeta=rmeta,
            rle_len=rle_len, no_size=no_size):
        out = bytearray(head)
        if rle_meta_jid is not None:
            c_rmeta = res.get(rle_meta_jid)
            if c_rmeta is None:
                return None
            if len(c_rmeta) < len(rmeta):
                varint.put_uint(out, len(rmeta) * 2)
                varint.put_uint(out, rle_len)
                varint.put_uint(out, len(c_rmeta))
                out += c_rmeta
            else:
                varint.put_uint(out, len(rmeta) * 2 + 1)
                varint.put_uint(out, rle_len)
                out += rmeta
        body = res.get(jid)
        if body is None:
            return None
        if len(body) >= in_size:
            out[0] = (out[0] & ~3 & 0xFF) | rans4x16.X_CAT | no_size
            body = data.tobytes()
        return bytes(out) + body

    return ("fin", fin)


def _encode_entropy_jobs(jobs: list, engine: str, dev,
                         bodies_fn=None) -> dict:
    """Encode deferred (data, order01) entropy jobs, batching same-shape
    groups through the device engine (``_bodies_o0`` / ``_bodies_o1``,
    whose groups of at least ``TABLES_DEVICE_MIN`` blocks build their
    tables on the card) or through ``bodies_fn`` (``compress_blocks``).
    Returns {jid: body bytes}."""
    results: dict[int, bytes] = {}
    groups: dict[tuple, list[int]] = defaultdict(list)
    for jid, (data, o) in enumerate(jobs):
        groups[(len(data), o)].append(jid)
    for (n, o), jids in groups.items():
        if _small_group(len(jids), n, engine) or n < 32:
            ENTROPY_JOBS["encode"]["host"] += len(jids)
            for jid in jids:
                d = jobs[jid][0]
                results[jid] = (rans4x16._compress_o1(d) if o
                                else rans4x16._compress_o0(d))
            continue
        ENTROPY_JOBS["encode"]["device"] += len(jids)
        batch = np.stack([jobs[j][0] for j in jids])
        bodies = bodies_fn(batch, o) if bodies_fn is not None else None
        if bodies is None:
            bodies = _bodies_o1(batch, dev) if o else _bodies_o0(batch, dev)
        for jid, body in zip(jids, bodies):
            results[jid] = body
    return results


def _compress_blocks_transform(arrs, order: int, engine: str, dev,
                               bodies_fn=None) -> list[bytes]:
    out: list[bytes | None] = [None] * len(arrs)
    jobs: list = []
    fins: list[tuple[int, tuple]] = []
    for i, a in enumerate(arrs):
        try:
            fins.append((i, _peel_encode(a, order, jobs)))
        except ValueError:
            out[i] = rans4x16.compress(a, order)
    res = _encode_entropy_jobs(jobs, engine, dev, bodies_fn) if jobs else {}
    for i, cand in fins:
        s = _finish(cand, res)
        out[i] = s if s is not None else rans4x16.compress(arrs[i], order)
    return out  # type: ignore[return-value]


def _frame(order_byte: int, n: int, body: bytes, data: np.ndarray) -> bytes:
    """Wrapper framing incl. the CAT fallback (compressed >= input)."""
    head = bytearray([order_byte])
    varint.put_uint(head, n)
    if len(body) >= n:
        head[0] = (head[0] & ~3 & 0xFF) | rans4x16.X_CAT
        return bytes(head) + data.tobytes()
    return bytes(head) + body


def _join_bodies(hdrs, states, words, counts) -> list[bytes]:
    """header + four state flushes + the block's words, per block; the
    words as ``convert.streams_to_host`` gives them (each block's stream
    at the end of its row)."""
    st = states.astype("<u4", copy=False)
    wd = words.astype("<u2", copy=False)
    W = wd.shape[1]
    return [hdrs[b] + st[b].tobytes() + wd[b, W - counts[b]:].tobytes()
            for b in range(len(hdrs))]


def _bodies_o0_devtables(batch: np.ndarray, dev) -> list[bytes] | None:
    """Order-0 entropy bodies with on-device table construction
    (ops/tables_v2.py); None -> the caller takes the host-table route.
    The batch goes to the device once: the table build and the encode
    read the same tensor."""
    jb = convert.as_tensor(batch, torch.uint8, dev)
    r = tables_v2.build_o0_device(jb, device=dev)
    if r is None:
        return None
    alpha_d, packed_d, _asz, fhdr, _A = r
    hdrs = native.serialize_o0_batch(fhdr)
    if hdrs is None:
        return None
    enc = rans_vmem.rans16_enc_packed(jb, alpha_d, packed_d, 12, 0)
    return _join_bodies(hdrs, *convert.streams_to_host(*enc))


def _mark(dev):
    """An event recorded on ``dev``'s current stream (the stream its
    tensors' work is queued on, whichever device is current); None on
    the CPU."""
    if dev.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    return event


def _copy_after(event, tensors):
    """Host copies of small device tensors, made on a side stream once
    ``event`` has passed, so that they run beside the work queued on
    the current stream since.  Returns (host tensors, done event); on
    the CPU (event None) the tensors themselves and None."""
    if event is None:
        return list(tensors), None
    side = torch.cuda.Stream(device=tensors[0].device)
    side.wait_event(event)
    with torch.cuda.stream(side):
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    return host, done


def _o1_devtables_launch(batch: np.ndarray, dev):
    """Queue the order-1 device-table route of a batch on ``dev``'s
    current stream: the table build, the encode with the per-block shift
    the table build chose, and the host copies of meta, header frequencies
    and alphabet on a side stream, launched AFTER the encode so that the
    host can serialise headers while the device encodes.  Returns what
    ``_o1_devtables_finish`` takes, or None (wide alphabet or tiny
    blocks: the caller takes the host-table route)."""
    jb = convert.as_tensor(batch, torch.uint8, dev)
    r = tables_v2.build_o1_device_async(jb, device=dev)
    if r is None:
        return None
    alpha_d, packed_d, fhdr_d, meta_d, H_d, _A = r
    built = _mark(dev)
    enc = rans_vmem.rans16_enc_packed(
        jb, alpha_d, packed_d.reshape(len(batch), -1), meta_d[:, 1], 1)
    host, done = _copy_after(built, (meta_d, fhdr_d, alpha_d))
    return enc, H_d, host, done


def _o1_devtables_finish(batch: np.ndarray, pending) -> list[bytes] | None:
    """Wait for ``_o1_devtables_launch``'s copies, serialise the headers
    and join the bodies.  Blocks whose banded shift decision really
    flips rebuild on the host, so streams stay byte-exact.  None -> the
    caller takes the host-table route."""
    enc, H_d, host, done = pending
    if done is not None:
        done.synchronize()
    meta, fhdr, alpha_h = (t.numpy() for t in host)
    hdrs = native.serialize_o1_dense_batch(alpha_h, meta[:, 0],
                                           fhdr.view(np.uint16), meta[:, 1])
    if hdrs is None:
        return None
    flag = tables_v2.resolve_band_flags(meta, H_d)
    bodies = _join_bodies(hdrs, *convert.streams_to_host(*enc))
    for b in np.flatnonzero(flag):
        bodies[b] = rans4x16._compress_o1(batch[b])
    return bodies


def _bodies_o1_devtables(batch: np.ndarray, dev) -> list[bytes] | None:
    """Order-1 entropy bodies with on-device table construction (the
    batch goes to the device once); None -> the caller takes the
    host-table route."""
    pending = _o1_devtables_launch(batch, dev)
    return None if pending is None else _o1_devtables_finish(batch, pending)


def _bodies_o0(batch: np.ndarray, dev) -> list[bytes]:
    """Entropy bodies (freq header + payload, no wrapper framing) for
    a batch of equal-length blocks, order 0."""
    B, N = batch.shape
    if not native.available():
        return [rans4x16._compress_o0(batch[b]) for b in range(B)]
    if B >= TABLES_DEVICE_MIN and N >= 32:
        res = _bodies_o0_devtables(batch, dev)
        if res is not None:
            TABLE_ROUTES["device"] += 1
            return res
    TABLE_ROUTES["host"] += 1
    res = _pmap(native.build_tables_o0, list(batch))
    if any(r is None for r in res):
        return [rans4x16._compress_o0(batch[b]) for b in range(B)]
    hdrs = [r[0] for r in res]
    starts = np.stack([r[1] for r in res])
    freqs = np.stack([r[2] for r in res])
    dense = rans_v2.densify_group_o0(freqs, starts)
    if dense is None:
        # wide alphabet: the native scalar coder takes it
        return _pmap(rans4x16._compress_o0, list(batch))
    alpha, packed, _ = dense
    enc = rans_v2._enc_tensors(batch, alpha, packed, 12, 0, dev)
    return _join_bodies(hdrs, *convert.streams_to_host(*enc))


def _bodies_o1(batch: np.ndarray, dev) -> list[bytes]:
    B, N = batch.shape
    if N < 8 or not native.available():
        return [rans4x16._compress_o1(batch[b]) for b in range(B)]
    if B >= TABLES_DEVICE_MIN and N >= 32:
        res = _bodies_o1_devtables(batch, dev)
        if res is not None:
            TABLE_ROUTES["device"] += 1
            return res
    TABLE_ROUTES["host"] += 1
    res = _pmap(native.build_tables_o1_dense, list(batch))
    if any(r is None for r in res):
        # wide alphabet (A > 96) somewhere: such data is rare (random
        # literals usually CAT out); thread the host coder
        return _pmap(rans4x16._compress_o1, list(batch))
    hdrs = [r[0] for r in res]
    # mixed 10/12-bit batches need no grouping: the shift is per block
    shifts = np.array([r[3] for r in res], np.int32)
    alpha, packed, _ = rans_v2.densify_builds((r[1], r[2]) for r in res)
    enc = rans_v2._enc_tensors(batch, alpha, packed, shifts, 1, dev)
    return _join_bodies(hdrs, *convert.streams_to_host(*enc))


# ---------------------------------------------------------------------
# decode

def _peel_wrapper(s: bytes, out_size):
    """Parse a non-STRIPE rans4x16 wrapper down to its entropy payload.

    Mirrors rans4x16._uncompress_into (reference
    rANS_static4x16pr.c:1435-1584) but DEFERS the entropy decode so
    payloads from many blocks batch together.  Returns
      ("cat", data np.uint8)                          — finished output
      ("entropy", order, body, tmp1 size, post)       — post(tmp1) -> np
    or None for anything this path cannot handle (the caller takes the
    host coder).
    """
    end = len(s)
    if end == 0:
        return None
    order = s[0]
    if order & rans4x16.X_STRIPE:
        return None
    pos = 1
    do_pack = order & rans4x16.X_PACK
    do_rle = order & rans4x16.X_RLE
    do_cat = order & rans4x16.X_CAT
    no_size = order & rans4x16.X_NOSZ
    order &= 1
    try:
        if not no_size:
            osz, pos = varint.get_uint(s, pos, end)
        else:
            if out_size is None:
                return None
            osz = out_size
        # a claim the host coder refuses (rans4x16._uncompress_o0/o1)
        # would otherwise size a device group at 2 GiB or more a block
        if osz >= 2**31 - 1 or (out_size is not None and osz > out_size):
            return None
        tmp1_size = osz

        pmap = None
        vpb = 0
        if do_pack:
            pmap, vpb, pos = pack.unpack_meta(s, pos, end)
            if pmap is None:
                return None
            psz, pos = varint.get_uint(s, pos, end)
            if psz > tmp1_size:
                return None
            tmp1_size = psz

        rle_meta = None
        if do_rle:
            u_meta_size, pos = varint.get_uint(s, pos, end)
            rle_len, pos = varint.get_uint(s, pos, end)
            if rle_len > tmp1_size:
                return None
            if u_meta_size & 1:
                u_meta = min(u_meta_size // 2, end - pos)
                rle_meta = bytes(s[pos:pos + u_meta])
                c_meta_size = u_meta
            else:
                c_meta_size, pos2 = varint.get_uint(s, pos, end)
                u_meta_size //= 2
                blob = rans4x16._uncompress_o0(
                    memoryview(s), pos2, end, u_meta_size)
                if blob is None:
                    return None
                rle_meta = blob.tobytes()
                pos = pos2
            if c_meta_size + pos > end:
                return None
            pos += c_meta_size
            tmp1_size = rle_len
    except Exception:
        # any malformed header: the host coder gives the verdict
        return None

    def post(tmp1: np.ndarray):
        tmp2 = tmp1
        if do_rle:
            if rle_meta is None or len(rle_meta) == 0:
                return None
            nsyms = rle_meta[0] if rle_meta[0] else 256
            if len(rle_meta) < 1 + nsyms:
                return None
            tmp2 = rle.decode(
                tmp1, rle_meta[1 + nsyms:],
                np.frombuffer(rle_meta[1:1 + nsyms], dtype=np.uint8), osz)
            if tmp2 is None:
                return None
        if do_pack:
            unpacked = len(tmp2) if vpb == 1 else osz
            return pack.unpack(tmp2, unpacked, vpb, pmap)
        return tmp2

    if end - pos == 0:
        r = post(np.zeros(0, np.uint8))
        return None if r is None else ("cat", r)
    if do_cat:
        if tmp1_size > end - pos or (out_size is not None
                                     and tmp1_size > out_size):
            return None
        r = post(np.frombuffer(s[pos:pos + tmp1_size], np.uint8))
        return None if r is None else ("cat", r)
    return ("entropy", order, s[pos:], tmp1_size, post)


def _peel_stripe(s: bytes, out_size):
    """Parse a STRIPE container into lane sub-streams.  Returns
    (ulen, N, [(sub_buf, lane_len), ...]) or None.  Lane i decodes
    against the rest of the container (rANS_static4x16pr.c:1412-1426).
    """
    end = len(s)
    try:
        ulen, pos = varint.get_uint(s, 1, end)
        if pos >= end:
            return None
        N = s[pos]
        pos += 1
        if N == 0:
            return None
        if out_size is not None and ulen != out_size:
            return None
        clens = []
        tot = 0
        for _ in range(N):
            c, pos = varint.get_uint(s, pos, end)
            if pos > end or c > end or c < 1:
                return None
            clens.append(c)
            tot += c
        if pos + tot > end:
            return None
    except Exception:
        # any malformed header: the host coder gives the verdict
        return None
    stripe_end = pos + tot
    lanes = []
    for i in range(N):
        lane_len = ulen // N + (1 if (ulen % N) > i else 0)
        lanes.append((s[pos:stripe_end], lane_len))
        pos += clens[i]
    return ulen, N, lanes


def uncompress_blocks(streams, out_sizes=None, engine: str = "auto",
                      device="cuda", dec_fn=None) -> list[bytes]:
    """Decompress a sequence of rANS 4x16 streams.

    Transform-flagged streams (PACK/RLE/CAT/NOSZ and STRIPE containers)
    are peeled on the host and their entropy payloads, every stripe
    lane's included, join the same batched device decode as the plain
    streams.

    dec_fn: optional decode-group engine ``(order01, osz, states (B,4)
    u32, words (B,W) u16 zero-padded, alpha, packed, shift) -> (B, osz)
    u8 | None``, called for every group that would reach the device
    engine; None from it sends the group the usual way."""
    dev = rans_v2.check_device(device)
    streams = [bytes(s) for s in streams]
    out: list[bytes | None] = [None] * len(streams)
    if any(not s for s in streams):
        raise ValueError("corrupt rans4x16 stream")

    use_batch = engine != "host" and native.available()

    def host(i):
        out[i] = rans4x16.uncompress(
            streams[i], out_sizes[i] if out_sizes is not None else None)

    # ---- peel wrappers into deferred entropy jobs --------------------
    # job: (jid, order, body, tmp1_size); finishers run after decode
    jobs: list[tuple] = []
    finishers: list[tuple] = []       # (i, kind, state)
    for i, s in enumerate(streams):
        osize = out_sizes[i] if out_sizes is not None else None
        if not use_batch:
            host(i)
            continue
        if s[0] & rans4x16.X_STRIPE:
            st = _peel_stripe(s, osize)
            if st is None:
                host(i)
                continue
            ulen, N, lanes = st
            lane_ids = []
            bad = False
            for sub, lane_len in lanes:
                p = _peel_wrapper(sub, lane_len)
                if p is None:
                    bad = True
                    break
                if p[0] == "cat":
                    if len(p[1]) != lane_len:
                        bad = True
                        break
                    lane_ids.append(("done", p[1]))
                else:
                    _k, order, body, t1, post = p
                    jid = len(jobs)
                    jobs.append((jid, order, body, t1))
                    lane_ids.append(("job", jid, post, lane_len))
            if bad:
                host(i)
                continue
            finishers.append((i, "stripe", (ulen, N, lane_ids)))
        else:
            p = _peel_wrapper(s, osize)
            if p is None:
                host(i)
            elif p[0] == "cat":
                out[i] = p[1].tobytes()
            else:
                _k, order, body, t1, post = p
                jid = len(jobs)
                jobs.append((jid, order, body, t1))
                finishers.append((i, "plain", (jid, post)))

    results = _decode_entropy_jobs(jobs, engine, dev, dec_fn) if jobs else {}

    # ---- assemble ----------------------------------------------------
    for i, kind, state in finishers:
        if kind == "plain":
            jid, post = state
            tmp1 = results.get(jid)
            r = post(tmp1) if tmp1 is not None else None
            if r is None:
                host(i)
            else:
                out[i] = r.tobytes()
        else:
            ulen, N, lane_ids = state
            buf = np.zeros(ulen, np.uint8)
            ok = True
            for li, lane_entry in enumerate(lane_ids):
                if lane_entry[0] == "done":
                    lane = lane_entry[1]
                else:
                    _t, jid, post, lane_len = lane_entry
                    tmp1 = results.get(jid)
                    lane = post(tmp1) if tmp1 is not None else None
                    if lane is None or len(lane) != lane_len:
                        ok = False
                        break
                buf[li::N] = lane
            if ok:
                out[i] = buf.tobytes()
            else:
                host(i)
    return out  # type: ignore[return-value]


def _host_decode(order: int, s: bytes, osz: int):
    if order:
        return rans4x16._uncompress_o1(memoryview(s), 0, len(s), osz)
    return rans4x16._uncompress_o0(memoryview(s), 0, len(s), osz)


def _decode_entropy_jobs(jobs, engine: str, dev, dec_fn=None) -> dict:
    """Decode a list of (jid, order, body, out_sz) rans4x16 entropy
    payloads, batching same-shape groups onto the device.  Returns
    {jid: np.uint8 array} (missing jid = parse failure)."""
    results: dict[int, np.ndarray] = {}
    groups: dict[tuple, list] = defaultdict(list)
    for jid, order, s, osz in jobs:
        if osz == 0:
            results[jid] = np.zeros(0, np.uint8)
            continue
        if order == 1:
            r = native.parse_tables_o1_dense(s)
            if r is not None:
                off, alpha, packed, shift = r
                if len(s) - off >= 16:
                    groups[(1, osz, shift)].append(
                        (jid, s, off, alpha, packed))
            else:
                # wide alphabet (A > 96): the native scalar decoder
                ENTROPY_JOBS["decode"]["host"] += 1
                rr = _host_decode(1, s, osz)
                if rr is not None:
                    results[jid] = rr
        else:
            r = native.parse_tables_o0(s)
            if r is None:
                continue
            off, ssym, sfreq, sbase = r
            if len(s) - off >= 16:
                groups[(0, osz)].append((jid, s, off, ssym, sfreq, sbase))

    for key, items in groups.items():
        order, osz = key[0], key[1]
        if _small_group(len(items), osz, engine):
            ENTROPY_JOBS["decode"]["host"] += len(items)
            for it in items:
                r = _host_decode(order, it[1], osz)
                if r is not None:
                    results[it[0]] = r
            continue
        B = len(items)
        nws = np.array([(len(s) - off - 16) // 2 for _, s, off, *_ in items],
                       np.int32)
        states = np.zeros((B, 4), np.uint32)
        words = np.zeros((B, max(int(nws.max()), 1)), "<u2")
        for k, (_, s, off, *_t) in enumerate(items):
            states[k] = np.frombuffer(s[off:off + 16], "<u4")
            words[k, :nws[k]] = np.frombuffer(
                s[off + 16: off + 16 + 2 * nws[k]], "<u2")
        if order == 1:
            shift = key[2]
            alpha, packed, _ = rans_v2.densify_builds(
                (t[3], t[4]) for t in items)
            dec = dec_fn(1, osz, states, words, alpha, packed,
                         shift) if dec_fn is not None else None
            if dec is None:
                dec = rans_v2.dec_o1_batch(states, words, osz, alpha,
                                           packed, shift, device=dev,
                                           counts=nws)
        else:
            # per-slot LUTs -> per-symbol tables: sbase[m] = m - start
            frs = np.zeros((B, 256), np.uint32)
            sts = np.zeros((B, 256), np.uint32)
            tot = items[0][4].shape[0]
            slot = np.arange(tot, dtype=np.uint32)
            for k, t in enumerate(items):
                sym = t[3].astype(np.int64)
                frs[k, sym] = t[4]
                sts[k, sym] = slot - t[5]
            dense = rans_v2.densify_group_o0(frs, sts)
            if dense is None:
                ENTROPY_JOBS["decode"]["host"] += len(items)
                for it in items:
                    rr = _host_decode(0, it[1], osz)
                    if rr is not None:
                        results[it[0]] = rr
                continue
            alpha, packed, _ = dense
            dec = dec_fn(0, osz, states, words, alpha, packed,
                         12) if dec_fn is not None else None
            if dec is None:
                dec = rans_v2.dec_o0_batch(states, words, osz, alpha,
                                           packed, device=dev, counts=nws)
        ENTROPY_JOBS["decode"]["device"] += len(items)
        for k, it in enumerate(items):
            results[it[0]] = dec[k]

    return results


# ---------------------------------------------------------------------
# rANS 4x8 (CRAM 3.0)

def _r8_dense_o0(res):
    """Order-0 (alphabet, packed) rows of a batch -> dense (alpha,
    packed), padded like ``densify_builds``' order-1 rows."""
    A = rans_v2._round_a(max(len(r[1]) for r in res))
    alpha = np.zeros((len(res), A), np.uint8)
    packed = np.zeros((len(res), A), np.int32)
    for k, (_tab, al, pk) in enumerate(res):
        alpha[k, :len(al)] = al
        alpha[k, len(al):] = al[-1] if len(al) else 0
        packed[k, :len(pk)] = pk
    return alpha, packed


def r4x8_compress_blocks(blocks, order: int, engine: str = "auto",
                         device="cuda", enc_fn=None) -> list[bytes]:
    """Compress a sequence of blocks with the rANS 4x8 codec (CRAM
    3.0), batching the payload scans onto the device.  Streams are
    byte-identical to ``rans4x8.compress`` in every path.

    engine: "auto" | "device" | "host".
    enc_fn: optional payload-scan engine ``(batch (B,N) u8, alpha,
    packed, order01) -> (states (B,4) u32, bytes (B,W) u8 each stream
    at the start of its row, counts (B,)) | None``; None from it sends
    the group the usual way.
    """
    dev = rans_v2.check_device(device)
    arrs = [_as_u8(b) for b in blocks]
    out: list[bytes | None] = [None] * len(arrs)
    groups: dict[int, list[int]] = defaultdict(list)
    for i, a in enumerate(arrs):
        if order in (0, 1) and engine != "host" and len(a) >= 8:
            groups[len(a)].append(i)
        else:
            out[i] = rans4x8.compress(a, order)
    for n, idxs in groups.items():
        res = None
        if not _small_group(len(idxs), n, engine) and native.available():
            batch = np.stack([arrs[i] for i in idxs])
            res = _pmap(lambda b: native.r8_build_tables_dense(b, order),
                        list(batch))
        if res is None or any(r is None for r in res):
            # small group, no native library, or an alphabet wider than
            # the dense tables take (A > 96) somewhere in the group
            for i in idxs:
                out[i] = rans4x8.compress(arrs[i], order)
            continue
        if order == 1:
            alpha, packed, _ = rans_v2.densify_builds(
                (r[1], r[2]) for r in res)
            enc = rans8_v2.enc_o1_batch
        else:
            alpha, packed = _r8_dense_o0(res)
            enc = rans8_v2.enc_o0_batch
        res8 = enc_fn(batch, alpha, packed, order) \
            if enc_fn is not None else None
        if res8 is None:
            res8 = enc(batch, alpha, packed, device=dev)
        states, wbytes, counts = res8
        st = states.astype("<u4", copy=False)
        for k, i in enumerate(idxs):
            tab = res[k][0]
            payload = st[k].tobytes() + wbytes[k, :counts[k]].tobytes()
            head = bytearray([order])
            head += (len(tab) + len(payload)).to_bytes(4, "little")
            head += n.to_bytes(4, "little")
            out[i] = bytes(head) + tab + payload
    return out  # type: ignore[return-value]


def _r8_parse_group(items, order: int):
    """Tables, states and byte streams of one (order, out size) group
    of 4x8 streams, or None when the group belongs on the host coder:
    a table that does not parse, an alphabet wider than the dense
    tables take, or a state below the coder's lower bound."""
    offs, rows = [], []
    for _i, s in items:
        if order:
            r = rans4x8.parse_tables_o1(s, want_sfb=False)
            # keep only the block's dense sub-table: 4096 x two
            # (256,256) arrays would be 2 GiB of host memory
            d = None if r is None else rans_v2.extract_dense(r[2], r[3])
            if d is None:
                return None
            rows.append(d)
        else:
            r = rans4x8.parse_tables_o0(s)
            if r is None:
                return None
            rows.append((r[4], r[5]))
        offs.append(r[0])
    if order:
        dense = rans_v2.densify_builds(rows)
    else:
        dense = rans_v2.densify_group_o0(np.stack([f for f, _b in rows]),
                                         np.stack([b for _f, b in rows]))
    if dense is None:
        return None
    alpha, packed, _ = dense
    B = len(items)
    nbs = np.array([len(s) - pos - 16 for (_i, s), pos in zip(items, offs)],
                   np.int32)
    states = np.zeros((B, 4), np.uint32)
    stream = np.zeros((B, max(int(nbs.max()), 1)), np.uint8)
    for k, ((_i, s), pos) in enumerate(zip(items, offs)):
        states[k] = np.frombuffer(s[pos:pos + 16], "<u4")
        stream[k, :nbs[k]] = np.frombuffer(s[pos + 16:], np.uint8)
    if (states < rans8_v2.RANS8_L).any():
        return None
    return states, stream, nbs, alpha, packed


def r4x8_uncompress_blocks(streams, engine: str = "auto",
                           device="cuda", dec_fn=None) -> list[bytes]:
    """Decompress a sequence of rANS 4x8 streams, batching the payload
    scans of each (order, out size) group onto the device.  Short,
    malformed or wide-alphabet streams, and claims of 2**31 - 1 bytes or
    more, go to ``rans4x8.uncompress``, which raises ValueError on a
    corrupt stream.

    dec_fn: optional decode-group engine ``(order01, osz, states (B,4)
    u32, stream (B,W) u8 zero-padded, alpha, packed) -> (B, osz) u8 |
    None``; None from it sends the group the usual way."""
    dev = rans_v2.check_device(device)
    streams = [bytes(s) for s in streams]
    out: list[bytes | None] = [None] * len(streams)
    groups: dict[tuple, list] = defaultdict(list)
    for i, s in enumerate(streams):
        osz = int.from_bytes(s[5:9], "little")
        # a claim of 2**31 - 1 bytes or more goes to the host coder,
        # which refuses it (ValueError), as it would size a device group
        # at 2 GiB or more a block
        if (len(s) < 9 or s[0] not in (0, 1) or engine == "host"
                or osz >= 2**31 - 1):
            out[i] = rans4x8.uncompress(s)
            continue
        groups[(s[0], osz)].append((i, s))
    for (order, osz), items in groups.items():
        parsed = None
        if osz >= 4 and not _small_group(len(items), osz, engine):
            parsed = _r8_parse_group(items, order)
        if parsed is None:
            for i, s in items:
                out[i] = rans4x8.uncompress(s)
            continue
        states, stream, nbs, alpha, packed = parsed
        res = dec_fn(order, osz, states, stream, alpha, packed) \
            if dec_fn is not None else None
        if res is None:
            dec = rans8_v2.dec_o1_batch if order else rans8_v2.dec_o0_batch
            res = dec(states, stream, osz, alpha, packed, device=dev,
                      counts=nbs)
        for k, (i, _s) in enumerate(items):
            out[i] = res[k].tobytes()
    return out  # type: ignore[return-value]


# ---------------------------------------------------------------------
# arith_dynamic (CRAM 3.1 adaptive range coder)

def arith_compress_blocks(blocks, order: int, engine: str = "auto",
                          device="cuda") -> list[bytes]:
    """Compress a sequence of blocks with the adaptive arith codec.

    Groups of equal-length blocks of a plain order (0 or 1) are coded by
    the batched engine; any other order bit-field and blocks under 8
    bytes go to ``arith.compress`` block by block.  Streams are
    byte-identical to ``arith.compress`` in every path.

    engine: "auto" | "device" | "host".
    """
    dev = rans_v2.check_device(device)
    arrs = [_as_u8(b) for b in blocks]
    out: list[bytes | None] = [None] * len(arrs)
    groups: dict[int, list[int]] = defaultdict(list)
    for i, a in enumerate(arrs):
        if order in (0, 1) and engine != "host" and len(a) >= 8:
            groups[len(a)].append(i)
        else:
            out[i] = arith.compress(a, order)
    for n, idxs in groups.items():
        if _small_group(len(idxs), n, engine):
            for i in idxs:
                out[i] = arith.compress(arrs[i], order)
            continue
        batch = np.stack([arrs[i] for i in idxs])
        ms = batch.max(axis=1).astype(np.int32) + 1
        res = arith_vmem.enc_batch(batch, np.full(len(idxs), n, np.int32),
                                   ms, order, device=dev)
        head = bytearray([order])
        varint.put_uint(head, n)
        for k, i in enumerate(idxs):
            # the stream stores a max symbol + 1 of 256 as 0
            if 1 + len(res[k]) >= n:
                out[i] = arith.compress(arrs[i], order)     # CAT framing
            else:
                out[i] = bytes(head) + bytes([int(ms[k]) & 0xFF]) + res[k]
    return out  # type: ignore[return-value]


def arith_uncompress_blocks(streams, out_sizes=None, engine: str = "auto",
                            device="cuda") -> list[bytes]:
    """Decompress a sequence of arith streams.

    Plain order-0/1 streams are peeled on the host and each (order,
    out size) group is decoded by the batched engine; flagged streams
    go to ``arith.uncompress``.  A valid stream decodes to the same
    bytes either way; a truncated one decodes as the batched engine
    defines it (reads past the end give 0), not as the host coder does.
    """
    dev = rans_v2.check_device(device)
    streams = [bytes(s) for s in streams]
    out: list[bytes | None] = [None] * len(streams)
    groups: dict[tuple, list] = defaultdict(list)

    def host(i):
        out[i] = arith.uncompress(
            streams[i], out_sizes[i] if out_sizes is not None else None)

    for i, s in enumerate(streams):
        if not s:
            raise ValueError("corrupt arith stream")
        if engine == "host" or s[0] & ~1 or len(s) < 3:
            host(i)
            continue
        osz, pos = varint.get_uint(s, 1, len(s))
        if (pos >= len(s) or not 0 < osz < 2**31 - 1
                or (out_sizes is not None and osz > out_sizes[i])):
            host(i)
            continue
        groups[(s[0], osz)].append((i, pos))
    for (order, osz), items in groups.items():
        if _small_group(len(items), osz, engine):
            for i, _pos in items:
                host(i)
            continue
        # the byte after the size is max symbol + 1, 256 stored as 0
        ms = [streams[i][pos] or 256 for i, pos in items]
        dec = arith_vmem.dec_batch(
            [streams[i][pos + 1:] for i, pos in items],
            [osz] * len(items), ms, order, device=dev)
        for k, (i, _pos) in enumerate(items):
            out[i] = dec[k].tobytes()
    return out  # type: ignore[return-value]


# ---------------------------------------------------------------------
# fqzcomp_qual (CRAM 3.1 quality codec)

def fqz_compress_blocks(jobs, engine: str = "auto",
                        device="cuda") -> list[bytes]:
    """Compress many fqzcomp_qual slices.

    jobs: sequence of (data, lens[, flags[, strat]]) tuples as accepted
    by ``fqz.compress``.  The batched path replays each job's models on
    the host (native C over the thread pool) and runs the range-coder
    chains of all jobs in one kernel; when the native replay refuses a
    job, and under engine="host", the jobs are coded by ``fqz.compress``
    over the thread pool.  Streams are byte-identical either way.
    Without the native host library the batched path raises
    RuntimeError; only engine="host" works then.

    engine: "auto" | "device" | "host".
    """
    dev = rans_v2.check_device(device)
    jobs = list(jobs)
    nbytes = sum(len(j[0]) for j in jobs) // max(len(jobs), 1)
    if engine != "host" and not _small_group(len(jobs), nbytes, engine):
        res = fqz.compress_batch_device(jobs, device=dev, pmap=_pmap)
        if res is not None:
            return res

    def one(job):
        data, lens, *rest = job
        flags = rest[0] if len(rest) > 0 else None
        strat = rest[1] if len(rest) > 1 else 0
        return fqz.compress(data, lens, flags, strat=strat)

    return _pmap(one, jobs)


def fqz_decompress_blocks(streams, engine: str = "auto") -> list[bytes]:
    """Decompress many fqzcomp_qual streams on the host, over the thread
    pool: the context of a symbol depends on the symbols decoded before
    it, so there is no batched decode (the JAX package has none either)
    and the call needs no device.  ``engine`` is accepted for the JAX
    signature's sake and ignored, as there."""
    return _pmap(fqz.decompress, [bytes(s) for s in streams])
