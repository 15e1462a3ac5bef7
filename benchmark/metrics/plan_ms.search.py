"""plan_ms.search: the port's exec.prepare span (utils.timings), summed over
the window, per search() call."""


def read(run):
    span = run.program_spans.get("exec.prepare")
    if not run.searches or span is None:
        return None
    return span["total_ms"] / run.searches
