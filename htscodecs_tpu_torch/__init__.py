"""htscodecs_tpu_torch — the PyTorch/CUDA port of htscodecs_tpu.

A second package beside the JAX one, which stays in the repository as
the frozen reference.  The port imports ``torch``, never ``jax``, and
nothing of ``htscodecs_tpu``: it keeps its own copy of the host code it
needs.  Ported so far, bitstream-identical to the reference: the
batched rANS 4x16 (CRAM 3.1), rANS 4x8 (CRAM 3.0) and arith_dynamic
(CRAM 3.1) codecs, order 0 and 1 each, and the fqzcomp_qual encode:

- ``models.batch``: the entry points (``compress_blocks /
  uncompress_blocks``, ``r4x8_*``, ``arith_*``, ``fqz_*``); groups of
  equal-length blocks go to the CUDA engines;
- ``models.rans4x16``, ``models.rans4x8``, ``models.arith``,
  ``models.fqz``: the single-block host codecs (the oracles, and the
  route of small groups and transform-flagged orders);
- ``ops.rans_vmem``, ``ops.rans8_vmem``, ``ops.arith_vmem``,
  ``ops.rc_vmem``, ``ops.rans_pallas``: eleven hand-written CUDA
  kernels (sources in ``csrc/``) with their plain PyTorch versions;
  built by ``nvcc`` at first use into ``_build/``;
- ``ops.tables_v2``: the rANS 4x16 frequency tables built on the
  device (the batch layer's route for large groups);
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
