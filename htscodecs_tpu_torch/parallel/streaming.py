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
queues each batch through the batch layer's device-table route
(``models.batch.launch_bodies``: on the device's current stream the
table build and the one 4x16 encoder, on a side stream the copies of
meta, alphabet and header frequencies into pinned host memory).  It
never waits for the device but where the table build reads its
alphabet size back.  Collecting a batch (``batch.finish_bodies``) waits
on that batch's copy event only, then serialises the headers, replays
the banded shift decisions and reads the payload's tail columns, all on
a stream of the encoder's own, so that the reads do not queue behind
the next batch's work; the encoder frames the streams.  Streams are
byte-identical to ``rans4x16.compress(block, order)`` for plain orders
0 and 1; transform-flagged orders belong to ``models.batch``.

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

from ..models import batch as batchmod
from ..models import rans4x16
from ..ops import convert, rans_v2


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
    pinned buffers).  ``assemble=False`` skips the read of the payload
    and returns, for an order-1 batch on the device route,
    ``batch.finish_bodies``' ``(hdrs, states, words, counts, flag,
    shift)``: header bytes per block, the encoder's states (B,4) int32
    and words (B,4K) int16 tensors on the device as it writes them
    (block b's stream is the LAST counts[b] words of its row,
    ``convert.streams_to_host`` reads it), and numpy counts, band flags
    (1: the caller must code that block on the host) and shifts.  An
    order-0 batch, and a batch that takes the host coder, comes back as
    assembled streams whatever ``assemble`` says, as in the JAX package.
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
        # (pending, or None for the host coder; the batch's host bytes)
        self._q: deque[tuple] = deque()
        self._ready_buf: list = []
        # the stream of collect's reads of the device (the payload, the
        # banded blocks' histograms, a wider s12 prefix): on the current
        # stream they would wait for the next batch's work queued there
        self._reads = (torch.cuda.Stream(device=self.dev)
                       if self.dev.type == "cuda" else None)

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
            self._ready_buf.append(self._collect(*self._q.popleft()))
        host = None
        if staged:
            blocks = convert.as_tensor(blocks, torch.uint8, self.dev)
            if self.order == 0:
                # order 0 frames on the host whatever ``assemble`` says
                host = blocks.cpu().numpy()
        else:
            host = blocks
        p = batchmod.launch_bodies(blocks, self.order, self.dev,
                                   hdr=self.hdr, prefix=self._nzpairs,
                                   reads=self._reads)
        if p is None and host is None:
            # wide alphabet or tiny blocks: the host coder at collect
            host = blocks.cpu().numpy()
        self._q.append((p, host))

    def _collect(self, p, host):
        res = None
        if p is not None:
            res = batchmod.finish_bodies(
                p, assemble=self.assemble or self.order == 0)
            if p.hdr is not None:
                self.hdr_bytes[p.hdr] += p.hdr_nbytes
            if p.need is not None:
                self._nzpairs = max(self._nzpairs or 0, -(-p.need * 5 // 4))
            if isinstance(res, tuple):
                return res
        if res is None:
            if host is None:    # a pre-staged batch the serialiser refused
                host = p.jb.cpu().numpy()
            return [rans4x16.compress(b, self.order) for b in host]
        N = host.shape[1]
        return [batchmod.frame(self.order, N, body, host[k])
                for k, body in enumerate(res)]

    def drain_ready(self):
        """Collect every batch whose slot must free up (and any that
        ``submit`` collected); keeps ``depth - 1`` in flight."""
        out = self._ready_buf
        self._ready_buf = []
        while len(self._q) > self.depth - 1:
            out.append(self._collect(*self._q.popleft()))
        return out

    def finish(self):
        """Collect every batch still in flight."""
        out = self._ready_buf
        self._ready_buf = []
        while self._q:
            out.append(self._collect(*self._q.popleft()))
        return out


def encode_batches(batches, order: int = 1, depth: int = 2, device="cuda"):
    """Encode an iterable of (B, N) batches, pipelined; yields one
    list[bytes] per batch, in submit order."""
    enc = StreamEncoder(order=order, depth=depth, device=device)
    for batch in batches:
        enc.submit(batch)
        yield from enc.drain_ready()
    yield from enc.finish()
