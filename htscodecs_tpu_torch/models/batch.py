"""Batched block codec API (rANS 4x16, rANS 4x8 and arith_dynamic,
order 0 and 1; the fqzcomp_qual encode).

Counterpart of ``htscodecs_tpu/models/batch.py`` for the plain orders.
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

Transform-flagged orders (PACK / RLE / STRIPE / NOSZ) are not batched
yet: they go to the host ``rans4x16.compress`` / ``uncompress`` block
by block, byte-exact.

Every entry point but the host-only ``fqz_decompress_blocks`` takes
``device`` and defaults to ``"cuda"``.  With no
card that default raises; ``device="cpu"`` runs the engine's plain
PyTorch versions (what the CPU tests do).  Nothing falls back from a
failed kernel to the CPU.
"""

from __future__ import annotations

import os
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import arith, fqz, rans4x8, rans4x16
from .. import native
from ..ops import arith_vmem, convert, rans8_v2, rans_v2, rans_vmem, tables_v2
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

# Host table construction is native C via ctypes (GIL released), so a
# thread pool scales it across cores.
_POOL = ThreadPoolExecutor(max_workers=min(16, (os.cpu_count() or 4)))

_TRANSFORM_FLAGS = (rans4x16.X_PACK | rans4x16.X_RLE | rans4x16.X_NOSZ
                    | rans4x16.X_STRIPE)


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
                    device="cuda") -> list[bytes]:
    """Compress a sequence of blocks with the rANS 4x16 codec.

    Plain orders 0/1 batch onto the device; any other reference order
    bit-field (PACK/RLE/NOSZ, STRIPE containers) is encoded by the host
    coder block by block.  Streams are byte-identical to
    ``rans4x16.compress`` in every path.

    engine: "auto" | "device" | "host".
    """
    dev = rans_v2.check_device(device)
    arrs = [_as_u8(b) for b in blocks]
    out: list[bytes | None] = [None] * len(arrs)

    plain_order = order in (0, 1)
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
        bodies = (_bodies_o1(batch, dev) if order == 1
                  else _bodies_o0(batch, dev))
        for k, i in enumerate(idxs):
            out[i] = _frame(order, n, bodies[k], batch[k])

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


def _bodies_o1_devtables(batch: np.ndarray, dev) -> list[bytes] | None:
    """Order-1 entropy bodies with on-device table construction.

    The batch goes to the device once.  The encode runs with the
    per-block shift the builder chose and is launched BEFORE the host
    copies meta, header frequencies and alphabet on a side stream, so
    the host serialises headers and replays banded shift decisions
    while the device encodes.  Blocks whose decision really flips
    rebuild on the host, so streams stay byte-exact.  None -> the
    caller takes the host-table route."""
    jb = convert.as_tensor(batch, torch.uint8, dev)
    r = tables_v2.build_o1_device_async(jb, device=dev)
    if r is None:
        return None
    alpha_d, packed_d, fhdr_d, meta_d, H_d, _A = r
    built = _mark(dev)
    enc = rans_vmem.rans16_enc_packed(
        jb, alpha_d, packed_d.reshape(len(batch), -1), meta_d[:, 1], 1)
    host, done = _copy_after(built, (meta_d, fhdr_d, alpha_d))
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
    """Parse a plain or CAT rans4x16 wrapper down to its entropy
    payload (the order byte carries no transform flag here).

    Mirrors rans4x16._uncompress_into (reference
    rANS_static4x16pr.c:1435-1584) but DEFERS the entropy decode so
    payloads from many blocks batch together.  Returns
      ("cat", data np.uint8)               — finished output
      ("entropy", order, body, out size)   — to be decoded
    or None for anything this path cannot handle (caller falls back).
    """
    end = len(s)
    order = s[0]
    do_cat = order & rans4x16.X_CAT
    order &= 1
    osz, pos = varint.get_uint(s, 1, end)
    if out_size is not None and osz > out_size:
        return None
    if end - pos == 0:
        return ("cat", np.zeros(0, np.uint8))
    if do_cat:
        if osz > end - pos:
            return None
        return ("cat", np.frombuffer(s[pos:pos + osz], np.uint8))
    return ("entropy", order, s[pos:], osz)


def uncompress_blocks(streams, out_sizes=None, engine: str = "auto",
                      device="cuda") -> list[bytes]:
    """Decompress a sequence of rANS 4x16 streams.

    Plain and CAT streams are peeled host-side and their entropy
    payloads batch onto the device; transform-flagged streams
    (PACK/RLE/NOSZ and STRIPE containers) are decoded by the host
    coder."""
    dev = rans_v2.check_device(device)
    streams = [bytes(s) for s in streams]
    out: list[bytes | None] = [None] * len(streams)
    if any(not s for s in streams):
        raise ValueError("corrupt rans4x16 stream")

    use_batch = engine != "host" and native.available()

    jobs: list[tuple] = []            # (jid, order, body, out size)
    owners: list[int] = []            # jid -> stream index
    for i, s in enumerate(streams):
        osize = out_sizes[i] if out_sizes is not None else None
        p = None
        if use_batch and not s[0] & _TRANSFORM_FLAGS:
            p = _peel_wrapper(s, osize)
        if p is None:
            out[i] = rans4x16.uncompress(s, osize)
        elif p[0] == "cat":
            out[i] = p[1].tobytes()
        else:
            _k, order, body, osz = p
            jobs.append((len(jobs), order, body, osz))
            owners.append(i)

    results = _decode_entropy_jobs(jobs, engine, dev) if jobs else {}

    for jid, i in enumerate(owners):
        r = results.get(jid)
        if r is None:
            out[i] = rans4x16.uncompress(
                streams[i], out_sizes[i] if out_sizes is not None else None)
        else:
            out[i] = r.tobytes()
    return out  # type: ignore[return-value]


def _host_decode(order: int, s: bytes, osz: int):
    if order:
        return rans4x16._uncompress_o1(memoryview(s), 0, len(s), osz)
    return rans4x16._uncompress_o0(memoryview(s), 0, len(s), osz)


def _decode_entropy_jobs(jobs, engine: str, dev) -> dict:
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
            dec = rans_v2.dec_o1_batch(states, words, osz, alpha, packed,
                                       shift, device=dev, counts=nws)
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
                for it in items:
                    rr = _host_decode(0, it[1], osz)
                    if rr is not None:
                        results[it[0]] = rr
                continue
            alpha, packed, _ = dense
            dec = rans_v2.dec_o0_batch(states, words, osz, alpha, packed,
                                       device=dev, counts=nws)
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
                         device="cuda") -> list[bytes]:
    """Compress a sequence of blocks with the rANS 4x8 codec (CRAM
    3.0), batching the payload scans onto the device.  Streams are
    byte-identical to ``rans4x8.compress`` in every path.

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
        states, wbytes, counts = enc(batch, alpha, packed, device=dev)
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
                           device="cuda") -> list[bytes]:
    """Decompress a sequence of rANS 4x8 streams, batching the payload
    scans of each (order, out size) group onto the device.  Short,
    malformed or wide-alphabet streams go to ``rans4x8.uncompress``,
    which raises ValueError on a corrupt stream."""
    dev = rans_v2.check_device(device)
    streams = [bytes(s) for s in streams]
    out: list[bytes | None] = [None] * len(streams)
    groups: dict[tuple, list] = defaultdict(list)
    for i, s in enumerate(streams):
        if len(s) < 9 or s[0] not in (0, 1) or engine == "host":
            out[i] = rans4x8.uncompress(s)
            continue
        osz = int.from_bytes(s[5:9], "little")
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
        dec = rans8_v2.dec_o1_batch if order else rans8_v2.dec_o0_batch
        res = dec(states, stream, osz, alpha, packed, device=dev, counts=nbs)
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


def fqz_decompress_blocks(streams) -> list[bytes]:
    """Decompress many fqzcomp_qual streams on the host, over the thread
    pool: the context of a symbol depends on the symbols decoded before
    it, so there is no batched decode (the JAX package has none either)
    and the call needs no device."""
    return _pmap(fqz.decompress, [bytes(s) for s in streams])
