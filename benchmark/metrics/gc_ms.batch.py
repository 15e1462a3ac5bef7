"""gc_ms.batch: the port's host.gc span (utils/timings.py, one a garbage
collection), summed over the untraced window, per batch, in ms."""


def read(run):
    span = run.program_spans.get("host.gc")
    if not run.batches or span is None:
        return None
    return span["total_ms"] / run.batches
