"""host_ms_per_call: the host's own time in the program per traced call, in
ms: the union of the program's ``eal.`` spans inside each call span, less
the union of its ``eal.wait`` spans (the host blocked on the device),
averaged over the calls. None without the card (``spans.per_call``)."""

from perfbench import spans


def read(rec, spec):
    calls = spans.per_call(rec.trace)
    if not any(calls):
        return None
    own = sum(spans.union_ns(c) - spans.union_ns([h for h in c if h[2] == "eal.wait"])
              for c in calls)
    return own / 1e6 / len(calls)
