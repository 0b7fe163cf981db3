"""rANS 4x8 (CRAM 3.0) through the port's batch entries.

The window drives ``models.batch.r4x8_compress_blocks(blocks,
order=...)`` and ``r4x8_uncompress_blocks(streams)`` with their
defaults; the plain reference of the streams is ``ref/rans4x8.py``.
"""

from __future__ import annotations

SPANS = [
    ("htscodecs_tpu_torch.native", "r8_build_tables_dense"),
    ("htscodecs_tpu_torch.ops.rans8_vmem", "rans8_enc"),
    ("htscodecs_tpu_torch.ops.rans8_vmem", "rans8_dec"),
    ("htscodecs_tpu_torch.ops.rans8_v2", "enc_o1_batch"),
    ("htscodecs_tpu_torch.ops.rans8_v2", "dec_o1_batch"),
    ("htscodecs_tpu_torch.ops.convert", "as_tensor"),
    ("htscodecs_tpu_torch.ops.convert", "streams8_to_reference"),
    ("htscodecs_tpu_torch.ops.convert", "streams8_from_reference"),
    ("htscodecs_tpu_torch.ops.convert", "tables8_from_reference"),
]


def entries(cfg: dict, device: str = "cuda"):
    from htscodecs_tpu_torch.models import batch
    kw = {} if device == "cuda" else {"device": device}
    order = int(cfg["order"])
    return (lambda blocks: batch.r4x8_compress_blocks(blocks, order=order,
                                                      **kw),
            lambda streams: batch.r4x8_uncompress_blocks(streams, **kw))


def reference_encode(blocks, cfg: dict):
    """The htscodecs streams of ``blocks`` (uint8 arrays of any
    lengths)."""
    from cram_bench.ref import rans4x8, ragged
    if int(cfg["order"]) != 1:
        raise ValueError("the rANS 4x8 reference writes order 1 only")
    return ragged.by_length(rans4x8.compress_o1, blocks)
