"""The comparison that decides ``correct``: the window's answers against the reference.

Every distinct answer the window returned for a pool query is judged
against the float64 reference (benchmark/reference.py) of that query:

  failed         queries whose call raised in the window
  answer_faults  answers of the wrong length, with a repeated id, or with
                 an id that is no live match of the query
  tie_faults     returned neighbours with equal scores whose ids descend,
                 and returned ids beaten by a left-out live document of
                 exactly the same reference score and a smaller app id
                 (exactly equal float64 scores come from equal inputs,
                 which the program scores alike, so docid ascending must
                 decide between them)
  topk_gap       the widest relative gap, over every answer and rank, of
                 the returned score from the reference's score of the
                 returned id, and of that from the reference's score at
                 that rank (a returned id that ranks below the reference's
                 list)

Each number has a limit (LIMITS; the readings they were set from are in
PERF.md); ``correct`` holds when every number is at most its limit.
"""

from __future__ import annotations

import math

import torch

LIMITS = {"failed": 0, "answer_faults": 0, "tie_faults": 0,
          "topk_gap": 1e-5}


def judge(ref, pool: list, answers: dict, k: int, failed: int) -> dict:
    """The numbers of the comparison: {name: value}, and "answers": how
    many distinct answers were judged. answers: {pool index: {answer as a
    tuple of (app id, score) pairs}}."""
    nums = {"failed": failed, "answer_faults": 0, "tie_faults": 0,
            "topk_gap": 0.0}
    judged = 0
    dev = ref.device
    for qi in sorted(answers):
        if not answers[qi]:
            continue
        dense, _, want = ref.search(pool[qi][1], k)
        for ans in answers[qi]:
            judged += 1
            ids = torch.tensor([a for a, _ in ans], dtype=torch.int64,
                               device=dev)
            got = torch.tensor([s for _, s in ans], dtype=torch.float64,
                               device=dev)
            if len(ans) != len(want) or len(set(ids.tolist())) != len(ans):
                nums["answer_faults"] += 1
                continue
            if not len(ans):
                continue
            inside = (ids >= 0) & (ids < len(ref.doc_of_app))
            docs = ref.doc_of_app[ids.clamp(0, len(ref.doc_of_app) - 1)]
            if not bool((inside & (docs >= 0)).all()):
                nums["answer_faults"] += 1
                continue
            rs = dense[docs]
            if not bool(torch.isfinite(rs).all()):
                nums["answer_faults"] += 1
                continue
            gap = torch.maximum((got - rs).abs() / rs, (want - rs) / want)
            nums["topk_gap"] = max(nums["topk_gap"], float(gap.max()))
            nums["tie_faults"] += int(((got[:-1] == got[1:])
                                       & (ids[:-1] > ids[1:])).sum())
            left_out = torch.ones_like(dense, dtype=torch.bool)
            left_out[docs] = False
            beaten = ((dense[None, :] == rs[:, None])
                      & (ref.app[None, :] < ids[:, None]) & left_out[None, :])
            nums["tie_faults"] += int(beaten.any(1).sum())
    nums["answers"] = judged
    return nums


def checks(nums: dict) -> dict:
    """{name: {"value", "limit"}} of every limited number."""
    return {n: {"value": nums[n], "limit": lim} for n, lim in LIMITS.items()}


def correct(nums: dict) -> bool:
    return all(nums[n] <= lim and not math.isnan(nums[n])
               for n, lim in LIMITS.items())

