"""schedule_ms_per_call: the host control plane's ms per traced call, the
time the program's ``eal.schedule`` spans cover inside each call span
(``runtime/phase_grid.py`` and the grids' fill and upload). None without
the card (``spans.per_call``)."""

from perfbench import spans


def read(rec, spec):
    return spans.ms_per_call(spans.per_call(rec.trace), "eal.schedule")
