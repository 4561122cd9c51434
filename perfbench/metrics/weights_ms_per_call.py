"""weights_ms_per_call: the host's ms per traced call in the fast tier's
weight build, the time the program's ``eal.weights`` spans cover inside each
call span (``ops/polyphase.py::banded_weights_device``: the row gathers, the
lerp, the selects and the indexed write of every chunk). None without the
span and without the card (``spans.per_call``)."""

from perfbench import spans


def read(rec, spec):
    return spans.ms_per_call(spans.per_call(rec.trace), "eal.weights")
