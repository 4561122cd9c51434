"""device_idle_share.mp3: the share of the traced window in which no kernel,
copy or set ran on the device (the union of their intervals), in %."""


def read(rec, spec):
    if rec.trace is None or not rec.trace.device:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
