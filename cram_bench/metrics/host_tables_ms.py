"""host_tables_ms: host milliseconds a call during which the native 4x8
table build (``native.r8_build_tables_dense``, over the thread pool)
was running on any thread: the union of its spans."""

SPAN = "native.r8_build_tables_dense"


def read(rec):
    if not any(n == SPAN for n, *_r in rec.spans):
        return None
    per = rec.per_call([SPAN])
    return 1e3 * sum(per) / len(per)
