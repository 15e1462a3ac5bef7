"""lazy_chunks.batch: the port's phrase.lazy_chunks counter
(utils/timings.py: the row chunks the lazy phrase groups run, each inside
the executor's fixed workspace), over the untraced window, per batch."""


def read(run):
    counter = run.program_spans.get("phrase.lazy_chunks")
    if not run.batches or counter is None:
        return None
    return counter["count"] / run.batches
