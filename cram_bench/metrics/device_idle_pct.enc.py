"""device_idle_pct.enc: the share of the window (first call's start to
last call's end) in which no kernel, copy or memset ran on the device,
in a write cell."""


def read(rec):
    return rec.idle_pct("write")
