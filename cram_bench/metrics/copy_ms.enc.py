"""copy_ms.enc: device milliseconds a call of host-to-device and
device-to-host copies in the window of a write cell."""


def read(rec):
    return rec.copy_ms("write")
