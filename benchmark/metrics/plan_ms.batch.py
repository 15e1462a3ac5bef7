"""plan_ms.batch: the port's exec.prepare span (utils.timings), summed over
the window, per batch (in a collection: every source's plan)."""


def read(run):
    span = run.program_spans.get("exec.prepare")
    if not run.batches or span is None:
        return None
    return span["total_ms"] / run.batches
