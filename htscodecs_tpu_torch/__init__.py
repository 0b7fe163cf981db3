"""htscodecs_tpu_torch — the PyTorch/CUDA port of htscodecs_tpu.

A second package beside the JAX one, which stays in the repository as
the frozen reference.  The port imports ``torch``, never ``jax``, and
nothing of ``htscodecs_tpu``: it keeps its own copy of the host code it
needs.  Ported so far: the batched rANS 4x16 codec, order 0 and 1
(CRAM 3.1), bitstream-identical to the reference:

- ``models.batch.compress_blocks / uncompress_blocks``: the entry
  points; groups of equal-length blocks go to the CUDA engine;
- ``models.rans4x16``: the single-block host codec with the full
  transform stack (the oracle, and the route of small groups, wide
  alphabets and transform-flagged orders);
- ``ops.rans_vmem``: three hand-written CUDA kernels (``rans16_dec``,
  ``sf_fetch``, ``rans16_enc``; sources in ``csrc/``) with their plain
  PyTorch versions; built by ``nvcc`` at first use into ``_build/``;
- ``ops.convert``: tables and streams between the reference's numpy
  layouts and the port's tensors;
- ``native``: the host C runtime (tables, scalar coders), built by the
  system C compiler at first use into ``_build/``.

Entry points take ``device=`` and default to ``"cuda"``; pass
``device="cpu"`` for the plain PyTorch versions.
"""

from . import utils  # noqa: F401
from .models import batch, rans4x16  # noqa: F401

__version__ = "0.1.0"


def version() -> str:
    return __version__
