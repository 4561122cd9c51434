"""roofline.polyphase_banded: the fast tier's banded contraction's share of
its roofline over the traced calls (banded_work.polyphase_banded_work per
launch, bytes at 3.35 TB/s or FP32 operations at 67 TFLOP/s, over the summed
device time of the contraction's two kernels, ``polyphase_banded_kernel`` and
the ``band_ranges_kernel`` each launch runs first), in %. Each kernel's count
of device events and launches goes to the run's log."""

from perfbench import banded_work


def read(rec, spec):
    if rec.trace is None or "polyphase_banded" not in rec.launches:
        return None
    return banded_work.roofline_share(rec.trace, rec.kernel_names["polyphase_banded"],
                                      rec.launches["polyphase_banded"],
                                      log=getattr(spec, "log", None))
