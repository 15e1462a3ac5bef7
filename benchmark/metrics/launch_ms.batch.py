"""launch_ms.batch: host ms per launch_batch call in the window (the
benchmark's own span around the call)."""


def read(run):
    s = run.spans.get("launch_batch")
    if not s:
        return None
    return sum(s) / len(s) * 1e3
