"""decoded_msamples_per_s: 44.1 kHz PCM samples (all channels) decoded and
carried through the 16 kHz resampler by every run of the window, over the
time from the window's start to the end of its last run, in millions a
second. Every run ends synchronised."""

from perfbench import yardstick


def read(rec, spec):
    if not rec.calls or "decoded_samples" not in rec.work:
        return None
    return yardstick.rate(rec.work["decoded_samples"], rec.calls[0][0], rec.calls[-1][1]) / 1e6
