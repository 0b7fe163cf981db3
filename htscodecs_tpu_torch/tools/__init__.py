"""Command-line tools mirroring the reference test binaries.

Counterparts of ``htscodecs_tpu/tools/``.  Each tool is
stream-compatible with its C counterpart and with the JAX package's
tool (same raw and framed modes), so archives can be moved between
them freely:

    python -m htscodecs_tpu_torch.tools.rans4x16 -o 193 < in > out
    python -m htscodecs_tpu_torch.tools.rans4x16 -d < out | cmp - in

``tok3`` reaches the batch layer and takes ``--device`` (default
``cuda``); the other four call the single-block host codecs.
"""
