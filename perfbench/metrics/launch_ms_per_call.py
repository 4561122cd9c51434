"""launch_ms_per_call: the host's ms per traced call in the hand kernels'
launch path, the time the program's ``eal.launch`` spans cover inside each
call span (the device switch and the ctypes entry). None without launches
and without the card (``spans.per_call``)."""

from perfbench import spans


def read(rec, spec):
    return spans.ms_per_call(spans.per_call(rec.trace), "eal.launch")
