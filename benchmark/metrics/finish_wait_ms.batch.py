"""finish_wait_ms.batch: the port's exec.device span (utils/timings.py),
summed over the untraced window, per batch: the host waiting on the card
and copying the results back inside finish_batch, in ms."""


def read(run):
    span = run.program_spans.get("exec.device")
    if not run.batches or span is None:
        return None
    return span["total_ms"] / run.batches
