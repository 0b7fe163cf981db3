"""host_parse_ms: host milliseconds a call spent in the native parses of
the 4x16 order-1 table headers (``native.parse_tables_o1_dense``)."""

SPAN = "native.parse_tables_o1_dense"


def read(rec):
    if not any(n == SPAN for n, *_r in rec.spans):
        return None
    per = rec.per_call([SPAN])
    return 1e3 * sum(per) / len(per)
