"""Pipelined rANS 4x16 encode of a stream of batches.

Counterpart of ``htscodecs_tpu/parallel/streaming.py``.  A CRAM writer
hands the codec a stream of slices of a few hundred 64 KiB blocks (cf.
the reference test tools' block loop, tests/rANS_static4x16pr_test.c:
190-207).  One small batch alone pays fixed costs: the host copies of
the tables' meta, alphabet and header frequencies, the header
serialisation and the framing.  Across consecutive batches they
pipeline: batch k's host work runs while batch k+1's table build and
encode are on the device.

``StreamEncoder`` keeps up to ``depth`` batches in flight.  ``submit``
queues, on the device's current stream, the table build
(``tables_v2.build_o1_device_async`` / ``build_o0_device``) and the one
4x16 encoder (``rans_vmem.rans16_enc_packed``, the block's shift from
the table build), and on a side stream the copies of meta, alphabet, header
frequencies and (when ``assemble``) states and words into pinned host
buffers that each in-flight slot allocates once and reuses.  It never
waits for the device but where the table build reads its alphabet size
back.  ``_collect`` waits on that batch's copy event only, then
serialises the headers, replays the banded shift decisions and frames
the streams.  Streams are byte-identical to
``rans4x16.compress(block, order)`` for plain orders 0 and 1;
transform-flagged orders belong to ``models.batch``.

The header frequencies travel as dense u16 (``hdr="u16"``) or as the
sparse 12-bit form (``hdr="s12"``: a presence bitmap and the row-compacted
nonzero values, ``tables_v2.pack_freqs_sparse12``), of which only a
prefix as wide as the largest nonzero count seen so far (with a quarter
spare) is copied; a batch that needs more is copied again at its width.
``"auto"`` picks s12 for alphabets wider than 8.  Streams are the same
under every transport.

Not carried over: the JAX encoder's ``seg_cap`` (the first compaction
tier of the TPU encode kernel, with its overflow retries) and
``_enc_vmem_padded`` (the batch padded to the kernel's 128-block
tiles).  The CUDA encoder writes each block's words at the end of its
own row, with no segment capacity to overflow, and takes any batch
size.  ``hdr`` and ``device`` are keyword-only: the JAX signature has
``seg_cap`` in the fourth place, so a positional call written for it,
``StreamEncoder(1, 2, True, None)``, raises ``TypeError`` here.

Reference: rANS_static4x16pr.c:378-494 (O0), :694-846 (O1); framing
:1231-1240 with the CAT expansion fallback :1332-1337.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from .. import native
from ..models import batch as batchmod
from ..models import rans4x16
from ..ops import convert, rans_v2, tables_v2
from ..ops.rans_vmem import rans16_enc_packed
from ..utils import varint


class _Slot:
    """The pinned host buffers of one in-flight batch, grown when a
    batch needs more and otherwise reused."""

    def __init__(self):
        self._bufs: dict[str, torch.Tensor] = {}

    def like(self, name: str, t: torch.Tensor) -> torch.Tensor:
        n = t.numel() * t.element_size()
        buf = self._bufs.get(name)
        if buf is None or buf.numel() < n:
            buf = torch.empty(max(n, 16), dtype=torch.uint8, pin_memory=True)
            self._bufs[name] = buf
        return buf[:n].view(t.dtype).view(t.shape)


class _Pending:
    """One submitted batch: what its collect needs, and every device
    tensor that its queued copies read, held until their event has
    passed (the caching allocator would otherwise hand their memory to
    the next batch while the side stream still reads it)."""

    __slots__ = ("blocks", "jb", "order", "assemble", "fhdr0", "dev_t",
                 "host", "done", "sparse", "H_d")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


class StreamEncoder:
    """Pipelined encoder for a stream of (B, N) batches.

    Usage::

        enc = StreamEncoder(order=1, depth=2)
        for batch in batches:          # (B, N) u8 arrays
            enc.submit(batch)
            for streams in enc.drain_ready():
                ...                    # list[bytes], one per block
        for streams in enc.finish():
            ...

    ``depth`` bounds the batches in flight (their device tensors and
    pinned buffers).  ``assemble=False`` skips the copies of the
    payload and returns, for an order-1 batch on the device route,
    ``(hdrs, states, words, counts, flag, shift)``: header bytes per
    block, the encoder's states (B,4) int32 and words (B,4K) int16
    tensors on the device as it writes them (block b's stream is the
    LAST counts[b] words of its row, ``convert.streams_to_host`` reads
    it), and numpy counts, band flags (1: the caller must code that
    block on the host) and shifts.  An order-0 batch, and a batch that
    takes the host coder, comes back as assembled streams whatever
    ``assemble`` says, as in the JAX package.
    """

    def __init__(self, order: int = 1, depth: int = 2,
                 assemble: bool = True, *, hdr: str = "auto",
                 device="cuda"):
        if order not in (0, 1):
            raise ValueError("StreamEncoder handles plain order 0/1")
        if hdr not in ("auto", "u16", "s12"):
            raise ValueError("hdr must be auto/u16/s12")
        self.dev = rans_v2.check_device(device)
        self.order = order
        self.depth = max(int(depth), 1)
        self.assemble = assemble
        self.hdr = hdr
        # s12 prefix width (value pairs) learned from earlier batches:
        # homogeneous streams settle after the first batch
        self._nzpairs: int | None = None
        # header-frequency bytes copied to the host, by transport
        self.hdr_bytes = {"u16": 0, "s12": 0}
        self._q: deque[_Pending] = deque()
        self._ready_buf: list = []
        self._cuda = self.dev.type == "cuda"
        self._side = torch.cuda.Stream(device=self.dev) if self._cuda else None
        # the stream of the host's own reads in _collect (the banded
        # blocks' histograms, a wider s12 prefix, a pre-staged batch's
        # bytes): on the current stream they would wait for the next
        # batch's work queued there
        self._reads = torch.cuda.Stream(device=self.dev) if self._cuda \
            else None
        self._slots = [_Slot() for _ in range(self.depth)] if self._cuda \
            else []
        self._nsub = 0

    # -- device side -------------------------------------------------

    def submit(self, blocks) -> None:
        """Queue one batch's device work and copies.

        ``blocks`` is a (B, N) uint8 numpy array, or a tensor already
        on the encoder's device (a slice of a resident corpus): that
        skips the host-to-device copy, but then ``assemble=False`` is
        required (the CAT framing and the host coder need host
        bytes)."""
        staged = isinstance(blocks, torch.Tensor)
        if staged and self.assemble:
            raise ValueError("pre-staged submit requires assemble=False")
        if not staged:
            blocks = np.ascontiguousarray(np.asarray(blocks, np.uint8))
        if blocks.ndim != 2:
            raise ValueError("submit expects a (B, N) batch")
        while len(self._q) >= self.depth:
            # bound the batches in flight; callers normally drain
            self._ready_buf.append(self._collect(self._q.popleft()))
        jb = convert.as_tensor(blocks, torch.uint8, self.dev)
        host_blocks = None if staged else blocks
        if self.order == 1:
            self._q.append(self._submit_o1(jb, host_blocks))
        else:
            self._q.append(self._submit_o0(jb, host_blocks))
        self._nsub += 1

    def _host_route(self, jb, blocks) -> _Pending:
        """A batch for the host coder: it needs the bytes on the host
        (a pre-staged batch is copied back here)."""
        if blocks is None:
            blocks = jb.cpu().numpy()
        return _Pending(blocks=blocks, order=self.order,
                        assemble=self.assemble)

    def _copies(self, after, tensors: dict, later: dict):
        """Host copies of ``tensors`` once ``after`` (an event on the
        current stream) has passed, and of ``later`` once everything
        queued on the current stream by now has: on the side stream into
        this slot's pinned buffers.  Returns (host tensors by name, done
        event).  On the CPU the tensors themselves and None."""
        if not self._cuda:
            return {**tensors, **later}, None
        slot = self._slots[self._nsub % self.depth]
        cur = torch.cuda.current_stream(self.dev)
        queued = torch.cuda.Event()
        queued.record(cur)
        host = {}
        with torch.cuda.stream(self._side):
            for ev, group in ((after, tensors), (queued, later)):
                if not group:
                    continue
                self._side.wait_event(ev)
                for name, t in group.items():
                    h = slot.like(name, t)
                    h.copy_(t, non_blocking=True)
                    host[name] = h
            done = torch.cuda.Event()
            done.record(self._side)
        return host, done

    def _submit_o1(self, jb, blocks) -> _Pending:
        st = tables_v2.build_o1_device_async(jb, device=self.dev)
        if st is None:
            # wide alphabet or tiny blocks: the host coder at collect
            return self._host_route(jb, blocks)
        alpha_d, packed_d, fhdr_d, meta_d, H_d, A = st
        B = jb.shape[0]
        s12 = (self.hdr == "s12"
               or (self.hdr == "auto" and A > 8
                   and native.get_lib() is not None))
        sparse = None           # (all packed values, prefix pairs copied)
        if s12:
            # pack before the encode so that its copy runs beside it
            bm_d, v12_d, _cnts, maxnz_d = tables_v2.pack_freqs_sparse12(fhdr_d)
            P = v12_d.shape[1] // 3
            tp = P if self._nzpairs is None else min(self._nzpairs, P)
            hdr_t = {"bitmap": bm_d, "vals": v12_d[:, :3 * tp].contiguous(),
                     "maxnz": maxnz_d.reshape(1)}
            sparse = (v12_d, tp)
            self.hdr_bytes["s12"] += sum(t.numel() * t.element_size()
                                         for t in hdr_t.values())
        else:
            hdr_t = {"fhdr": fhdr_d}
            self.hdr_bytes["u16"] += fhdr_d.numel() * 2
        built = batchmod._mark(self.dev)
        states, words, counts = rans16_enc_packed(
            jb, alpha_d, packed_d.reshape(B, -1), meta_d[:, 1], 1)
        later = {"counts": counts}
        if self.assemble:
            later.update(states=states, words=words)
        host, done = self._copies(
            built, {"meta": meta_d, "alpha": alpha_d, **hdr_t}, later)
        return _Pending(blocks=blocks, jb=jb, order=1,
                        assemble=self.assemble, host=host, done=done,
                        sparse=sparse, H_d=H_d,
                        dev_t=(alpha_d, packed_d, fhdr_d, meta_d, states,
                               words, counts, hdr_t))

    def _submit_o0(self, jb, blocks) -> _Pending:
        if blocks is None:
            # order 0 frames on the host whatever ``assemble`` says
            blocks = jb.cpu().numpy()
        r0 = tables_v2.build_o0_device(jb, device=self.dev)
        if r0 is None:
            return self._host_route(jb, blocks)
        alpha_d, packed_d, _asz, fhdr, _A = r0
        states, words, counts = rans16_enc_packed(jb, alpha_d, packed_d, 12, 0)
        host, done = self._copies(
            None, {}, {"states": states, "words": words, "counts": counts})
        return _Pending(blocks=blocks, jb=jb, order=0,
                        assemble=self.assemble, host=host, done=done,
                        fhdr0=fhdr, dev_t=(alpha_d, packed_d, states, words,
                                           counts))

    # -- host side ---------------------------------------------------

    def _collect(self, p: _Pending):
        if p.host is None:                      # the host coder's route
            return [rans4x16.compress(b, p.order) for b in p.blocks]
        if p.done is not None:
            # the batch's copies, and so its table build and encode,
            # have passed: what it left on the device may be read on
            # another stream
            p.done.synchronize()
        if self._reads is None:
            return self._finish(p)
        with torch.cuda.stream(self._reads):
            return self._finish(p)

    def _finish(self, p: _Pending):
        h = {k: t.numpy() for k, t in p.host.items()}
        N = p.jb.shape[1]
        if p.order == 0:
            hdrs = native.serialize_o0_batch(p.fhdr0)
            if hdrs is None:
                return [rans4x16.compress(b, 0) for b in p.blocks]
            bodies = batchmod._join_bodies(
                hdrs, h["states"].view(np.uint32), h["words"].view(np.uint16),
                h["counts"])
            return [_frame_plain(0, N, body, p.blocks[k])
                    for k, body in enumerate(bodies)]
        meta = h["meta"].copy()
        asz, shift = meta[:, 0], meta[:, 1]
        flag = tables_v2.resolve_band_flags(meta, p.H_d)
        if p.sparse is not None:
            v12_d, tp = p.sparse
            need = -(-int(h["maxnz"][0]) // 2)
            vals = h["vals"]
            if need > tp:               # prefix too narrow: copy again
                vals = v12_d[:, :3 * need].cpu().numpy()
                self.hdr_bytes["s12"] += vals.size
            self._nzpairs = max(self._nzpairs or 0, -(-need * 5 // 4))
            hdrs = native.serialize_o1_sparse12_batch(
                h["alpha"], asz, h["bitmap"], vals, shift)
        else:
            hdrs = native.serialize_o1_dense_batch(
                h["alpha"], asz, h["fhdr"].view(np.uint16), shift)
        if hdrs is None:
            blocks = p.blocks if p.blocks is not None else p.jb.cpu().numpy()
            return [rans4x16.compress(b, 1) for b in blocks]
        counts = h["counts"].copy()
        if not p.assemble:
            states, words = p.dev_t[4], p.dev_t[5]
            return (hdrs, states, words, counts, flag, shift.copy())
        bodies = batchmod._join_bodies(
            hdrs, h["states"].view(np.uint32), h["words"].view(np.uint16),
            counts)
        out = []
        for b in range(len(bodies)):
            body = (rans4x16._compress_o1(p.blocks[b]) if flag[b]
                    else bodies[b])
            out.append(_frame_plain(1, N, body, p.blocks[b]))
        return out

    def drain_ready(self):
        """Collect every batch whose slot must free up (and any that
        ``submit`` collected); keeps ``depth - 1`` in flight."""
        out = self._ready_buf
        self._ready_buf = []
        while len(self._q) > self.depth - 1:
            out.append(self._collect(self._q.popleft()))
        return out

    def finish(self):
        """Collect every batch still in flight."""
        out = self._ready_buf
        self._ready_buf = []
        while self._q:
            out.append(self._collect(self._q.popleft()))
        return out


def _frame_plain(order_byte: int, n: int, body: bytes,
                 data: np.ndarray) -> bytes:
    """Plain-order wrapper framing with the CAT expansion fallback
    (rANS_static4x16pr.c:1231-1240, :1332-1337)."""
    head = bytearray([order_byte])
    varint.put_uint(head, n)
    if len(body) >= n:
        head[0] = rans4x16.X_CAT
        return bytes(head) + data.tobytes()
    return bytes(head) + body


def encode_batches(batches, order: int = 1, depth: int = 2, device="cuda"):
    """Encode an iterable of (B, N) batches, pipelined; yields one
    list[bytes] per batch, in submit order."""
    enc = StreamEncoder(order=order, depth=depth, device=device)
    for batch in batches:
        enc.submit(batch)
        yield from enc.drain_ready()
    yield from enc.finish()
