"""phrase_syncs.batch: the port's phrase.syncs counter (utils/timings.py:
the host's waits on the device in verification and the lazy routes: live
counts, window trip counts, candidate and resolved-flag reads), over the
untraced window, per batch."""


def read(run):
    counter = run.program_spans.get("phrase.syncs")
    if not run.batches or counter is None:
        return None
    return counter["count"] / run.batches
