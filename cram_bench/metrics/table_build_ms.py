"""table_build_ms: device milliseconds a call of the kernels launched
inside ``tables_v2.build_o1_device_async`` (the 4x16 device table
build), by the launch times of the trace."""

SPAN = "ops.tables_v2.build_o1_device_async"


def read(rec):
    spans = sorted((a, b) for n, a, b, _t in rec.spans if n == SPAN)
    if not spans or not rec.calls:
        return None
    total = 0.0
    for o in rec.ops("kernel"):
        if o.launch is not None and any(a <= o.launch <= b
                                        for a, b in spans):
            total += o.t1 - o.t0
    return 1e3 * total / len(rec.calls)
