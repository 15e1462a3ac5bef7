"""Closed loop of batches with one batch in flight ahead.

The client launches batch i+1 (``launch_batch``) before it finishes batch
i (``finish_batch``), as chip_smoke.py's ``qps`` does, replaying the pool's
batches in order. A batch's time runs from its ``launch_batch`` call to
the return of its ``finish_batch``. The client reads every result it gets
back: each answer, as (app id, score) pairs, joins its query's set of
distinct answers, which the reference judges after the window. Spans:
``launch_batch``, ``finish_batch`` and ``batch``, each (start, end) on the
host clock.
"""

from __future__ import annotations

import time
import traceback


def run(system, batches: list, traffic: dict, seconds: float = None,
        rounds: int = None) -> dict:
    """Launch batches until `seconds` have passed (or `rounds` batches
    were launched), then finish the one in flight."""
    k, scorer = traffic["k"], traffic["scorer"]
    texts = [[q for q, _ in b] for b in batches]
    clock = time.perf_counter
    spans = {"launch_batch": [], "finish_batch": [], "batch": []}
    answers = {i: set() for i in range(len(texts) * len(texts[0]))}
    launched = []
    attempted = failed = completed = 0
    t_start = clock()
    deadline = t_start + (seconds if seconds is not None else float("inf"))

    def launch(bi):
        t0 = clock()
        h = system.launch_batch(texts[bi], k=k, scorer=scorer)
        spans["launch_batch"].append((t0, clock()))
        launched.append(bi)
        return bi, h, t0

    pending = None
    try:
        attempted += len(texts[0])
        pending = launch(0)
        while pending is not None:
            nxt = None
            n = len(launched)
            if clock() < deadline and (rounds is None or n < rounds):
                bi = n % len(texts)
                attempted += len(texts[bi])
                nxt = launch(bi)
            t2 = clock()
            res = system.finish_batch(pending[1])
            t3 = clock()
            spans["finish_batch"].append((t2, t3))
            spans["batch"].append((pending[2], t3))
            base = pending[0] * len(texts[0])
            for j, r in enumerate(res):
                answers[base + j].add(tuple((x.doc_id, x.score) for x in r))
            completed += len(res)
            pending = nxt
    except Exception:  # the window ends; the run reports the failure
        traceback.print_exc()
        failed = attempted - completed
    return {"window_s": clock() - t_start, "spans": spans,
            "answers": answers, "completed": completed,
            "launched": launched, "attempted": attempted, "failed": failed}


def warm(system, batches: list, traffic: dict) -> None:
    """Two pipelined passes over the pool: every launch shape of the
    window, each with a batch in flight before it."""
    out = run(system, batches, traffic, rounds=2 * len(batches))
    if out["failed"]:
        raise RuntimeError("warm-up failed")
