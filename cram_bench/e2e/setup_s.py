"""setup_s: seconds from the start of the process to the end of the warm
call (torch and the CUDA context, the port's builds or their cache,
the blocks, a read cell's reference streams, one call at the cell's
shapes)."""


def read(rec):
    return rec.setup_s
