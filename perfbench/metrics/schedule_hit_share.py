"""schedule_hit_share: the share of traced calls, in %, that took over the
resampler schedule the call before built for them: an ``eal.schedule.hit``
span inside the call span (``Resampler.resample_stream``). None without such
a span, as from a program that builds every schedule at its call's head, and
without the card (``spans.per_call``)."""

from perfbench import spans

HIT = "eal.schedule.hit"


def read(rec, spec):
    calls = spans.per_call(rec.trace)
    hits = sum(any(h[2] == HIT for h in c) for c in calls)
    return 100.0 * hits / len(calls) if hits else None
