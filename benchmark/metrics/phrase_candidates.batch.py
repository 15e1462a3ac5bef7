"""phrase_candidates.batch: the port's phrase.candidates counter
(utils/timings.py: the live candidates each position verification on the
device checks), over the untraced window, per batch."""


def read(run):
    counter = run.program_spans.get("phrase.candidates")
    if not run.batches or counter is None:
        return None
    return counter["count"] / run.batches
