"""lazy_ms.batch: the port's exec.group.lazyph span (utils/timings.py: each
lazy phrase group, from its decode through verification and selection),
summed over the untraced window, per batch, in ms."""


def read(run):
    span = run.program_spans.get("exec.group.lazyph")
    if not run.batches or span is None:
        return None
    return span["total_ms"] / run.batches
