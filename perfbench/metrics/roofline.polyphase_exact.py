"""roofline.polyphase_exact: the exact polyphase kernel's share of its
roofline over the traced calls (yardstick.polyphase_exact_work per launch,
bytes at 3.35 TB/s or FP32 operations at 67 TFLOP/s, over the kernel's
device time), in %."""

from perfbench import yardstick


def read(rec, spec):
    if rec.trace is None or "polyphase_exact" not in rec.launches:
        return None
    return yardstick.roofline_share(rec.trace, rec.kernel_names["polyphase_exact"],
                                    rec.launches["polyphase_exact"])
