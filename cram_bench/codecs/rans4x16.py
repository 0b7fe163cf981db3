"""rANS-Nx16 (CRAM 3.1) through the port's batch entries.

The window drives ``models.batch.compress_blocks(blocks, order=...)``
and ``uncompress_blocks(streams)`` with their defaults (engine "auto",
device "cuda"); the plain reference of the streams is
``ref/rans4x16.py``.  Nothing of the program is imported until
``entries`` is called, so the reference's worker processes never load
it.
"""

from __future__ import annotations

# (module, attribute) pairs that a traced run wraps in host spans;
# models/batch.py reaches each through its module, so the wrapper is
# what the batch layer calls
SPANS = [
    ("htscodecs_tpu_torch.ops.tables_v2", "build_o1_device_async"),
    ("htscodecs_tpu_torch.ops.tables_v2", "resolve_band_flags"),
    ("htscodecs_tpu_torch.native", "build_tables_o1_dense"),
    ("htscodecs_tpu_torch.native", "serialize_o1_dense_batch"),
    ("htscodecs_tpu_torch.native", "parse_tables_o1_dense"),
    ("htscodecs_tpu_torch.ops.convert", "as_tensor"),
    ("htscodecs_tpu_torch.ops.convert", "streams_to_host"),
    ("htscodecs_tpu_torch.ops.convert", "streams_from_reference"),
    ("htscodecs_tpu_torch.ops.convert", "tables_from_reference"),
    ("htscodecs_tpu_torch.ops.rans_v2", "dec_o1_batch"),
    ("htscodecs_tpu_torch.ops.rans_vmem", "rans16_enc_packed"),
    ("htscodecs_tpu_torch.ops.rans_vmem", "rans16_dec"),
]


def entries(cfg: dict, device: str = "cuda"):
    """(write, read): the program's entries for this configuration."""
    from htscodecs_tpu_torch.models import batch
    kw = {} if device == "cuda" else {"device": device}
    order = int(cfg["order"])
    return (lambda blocks: batch.compress_blocks(blocks, order=order, **kw),
            lambda streams: batch.uncompress_blocks(streams, **kw))


def reference_encode(blocks, cfg: dict):
    """The htscodecs streams of ``blocks`` (uint8 arrays of any
    lengths)."""
    from cram_bench.ref import rans4x16, ragged
    if int(cfg["order"]) != 1:
        raise ValueError("the rANS-Nx16 reference writes order 1 only")
    return ragged.by_length(rans4x16.compress_o1, blocks)
