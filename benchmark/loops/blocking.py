"""One client calling the blocking ``search(q, k)`` one query at a time.

The client replays the pool in order and sends the next query when the
last one returned. It reads every result it gets back: each answer, as
(app id, score) pairs, joins its query's set of distinct answers, which
the reference judges after the window. Span: ``search``, (start, end) on
the host clock.
"""

from __future__ import annotations

import time
import traceback


def run(system, batches: list, traffic: dict, seconds: float) -> dict:
    """Search until `seconds` have passed."""
    k, scorer = traffic["k"], traffic["scorer"]
    texts = [q for b in batches for q, _ in b]
    clock = time.perf_counter
    spans = {"search": []}
    answers = {i: set() for i in range(len(texts))}
    attempted = failed = completed = 0
    t_start = clock()
    deadline = t_start + seconds
    try:
        while clock() < deadline:
            qi = attempted % len(texts)
            attempted += 1
            t0 = clock()
            res = system.search(texts[qi], k=k, scorer=scorer)
            spans["search"].append((t0, clock()))
            answers[qi].add(tuple((x.doc_id, x.score) for x in res))
            completed += 1
    except Exception:  # the window ends; the run reports the failure
        traceback.print_exc()
        failed = 1
    return {"window_s": clock() - t_start, "spans": spans,
            "answers": answers, "completed": completed, "launched": [],
            "attempted": attempted, "failed": failed}


def warm(system, batches: list, traffic: dict) -> None:
    """The port's own warmup over the pool's queries, one at a time on one
    thread: the window's launch shapes and the hot caches."""
    system.warmup([q for b in batches for q, _ in b], k=traffic["k"],
                  scorer=traffic["scorer"], batch=False, threads=1)
