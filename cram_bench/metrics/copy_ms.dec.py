"""copy_ms.dec: device milliseconds a call of host-to-device and
device-to-host copies in the window of a read cell."""


def read(rec):
    return rec.copy_ms("read")
