"""launches_per_call: the program's ``eal.launch`` spans per traced call
span, one a hand-kernel launch. None without launches and without the card
(``spans.per_call``)."""

from perfbench import spans


def read(rec, spec):
    calls = spans.per_call(rec.trace)
    n = sum(h[2] == "eal.launch" for c in calls for h in c)
    return n / len(calls) if n else None
