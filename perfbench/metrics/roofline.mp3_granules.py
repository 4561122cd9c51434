"""roofline.mp3_granules: the exact MP3 granule kernel's share of its
roofline over the traced runs (yardstick.mp3_granules_work per launch,
bytes at 3.35 TB/s or integer operations at the assumed PEAK_INT32, over the
kernel's device time), in %."""

from perfbench import yardstick


def read(rec, spec):
    if rec.trace is None or "mp3_granules" not in rec.launches:
        return None
    return yardstick.roofline_share(rec.trace, rec.kernel_names["mp3_granules"],
                                    rec.launches["mp3_granules"])
