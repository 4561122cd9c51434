"""decode_ms_per_run: the mean wall time of ``decode_run(..., to_device=True)``
over the traced runs, from a span the benchmark puts around each call and
synchronises (only in a traced run), in ms."""


def read(rec, spec):
    spans = [s for s in rec.work.get("decode_s", []) if s is not None]
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
