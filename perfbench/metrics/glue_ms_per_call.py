"""glue_ms_per_call: device ms per traced call of every device operation
that is not one of the program's hand-written kernels (torch ops, copies,
sets), summed over the trace."""

from perfbench import yardstick


def read(rec, spec):
    if rec.trace is None or not rec.trace.calls or not rec.trace.device:
        return None
    hand = yardstick.hand_kernels(spec.repo / "esp_audio_libs_tpu_torch" / "csrc")
    glue = sum(sec for name, (_, sec) in rec.trace.by_name().items()
               if not yardstick.is_hand(name, hand))
    return glue * 1e3 / rec.trace.calls
