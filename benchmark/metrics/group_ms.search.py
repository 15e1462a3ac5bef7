"""group_ms.search: the port's exec.group.<kind> spans (utils/timings.py:
each group's upload, launches and host work up to its top-k), summed over
every kind and the untraced window, per search() call, in ms."""


def read(run):
    spans = [v for k, v in run.program_spans.items()
             if k.startswith("exec.group.")]
    if not run.searches or not spans:
        return None
    return sum(s["total_ms"] for s in spans) / run.searches
