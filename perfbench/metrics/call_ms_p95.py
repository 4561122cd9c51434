"""call_ms_p95: the 95th percentile of the wall time of every call of the
window, each call synchronised, in ms."""

from perfbench import yardstick


def read(rec, spec):
    if not rec.calls:
        return None
    return yardstick.percentile([(e - s) * 1e3 for s, e in rec.calls], 95)
