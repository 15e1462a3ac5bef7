"""finish_ms.batch: host ms per finish_batch call in the window (the
benchmark's own span around the call: the wait for the card, the copies,
the results)."""


def read(run):
    s = run.spans.get("finish_batch")
    if not s:
        return None
    return sum(s) / len(s) * 1e3
