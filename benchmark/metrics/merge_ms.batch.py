"""merge_ms.batch: the port's collection.merge span (utils/timings.py), the
merge of the sources' results by score and app id, summed over the
untraced window, per batch, in ms."""


def read(run):
    span = run.program_spans.get("collection.merge")
    if not run.batches or span is None:
        return None
    return span["total_ms"] / run.batches
