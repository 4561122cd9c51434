"""input_msamples_per_s: input samples (frames x channels x streams) of
every call of the window, over the time from the window's start to the end
of its last call, in millions a second. Every call ends synchronised."""

from perfbench import yardstick


def read(rec, spec):
    if not rec.calls or "input_samples_per_call" not in rec.work:
        return None
    start, end = rec.calls[0][0], rec.calls[-1][1]
    return yardstick.rate(rec.work["input_samples_per_call"] * len(rec.calls), start, end) / 1e6
