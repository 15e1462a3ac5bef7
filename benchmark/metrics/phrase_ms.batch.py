"""phrase_ms.batch: the port's exec.phrase span (utils/timings.py), summed
over the untraced window, per batch: the phrase work on the host (the
posmask member loop, position verification, the host verifier, the lazy
reruns), in ms."""


def read(run):
    span = run.program_spans.get("exec.phrase")
    if not run.batches or span is None:
        return None
    return span["total_ms"] / run.batches
