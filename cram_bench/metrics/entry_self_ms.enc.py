"""entry_self_ms.enc: host milliseconds a call outside every wrapped layer
(the call's wall minus the union of the wrapped functions' spans, on
any thread): stacking, grouping, framing and per-block Python of
models/batch.py, in a write cell."""


def read(rec):
    return rec.self_ms("write")
