"""df_lookups.batch: the port's plan.df_lookups counter (utils/timings.py:
the df_of calls of each plan_batch; in a collection, every source's plan
asks the collection, which walks every source), over the untraced window,
per batch."""


def read(run):
    counter = run.program_spans.get("plan.df_lookups")
    if not run.batches or counter is None:
        return None
    return counter["count"] / run.batches
