"""roofline.biquad_exact: the exact biquad kernel's share of its roofline
over the traced calls (yardstick.biquad_work per launch, bytes at 3.35 TB/s
or FP32 operations at 67 TFLOP/s, over the kernel's device time), in %."""

from perfbench import yardstick


def read(rec, spec):
    if rec.trace is None or "biquad_exact" not in rec.launches:
        return None
    return yardstick.roofline_share(rec.trace, rec.kernel_names["biquad_exact"],
                                    rec.launches["biquad_exact"])
