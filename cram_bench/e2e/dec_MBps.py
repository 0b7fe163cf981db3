"""dec_MBps: a reader's throughput, the decoded bytes of every call of
the window over the time from the first call's start to the last call's
end, in 10**6 bytes a second."""


def read(rec):
    if rec.direction != "read" or not rec.calls:
        return None
    t0, t1 = rec.window()
    return sum(c.raw_bytes for c in rec.calls) / (t1 - t0) / 1e6
